"""Interactive viewer — the framework's L6 app shell.

The reference is an interactive browser app: a Tweakpane panel binds every
renderer parameter, OrbitControls drive the camera, the canvas shows the
progressive render live, and fps / per-pass timings are on screen
(reference: src/main.ts:78-400).  The port of `tpu_pathtracer.viewer`: the
render loop runs server-side next to the card, and a dependency-free HTTP
server streams progressive frames + state to a small browser page with the
same control surface.

Usage:  python -m tpu_pathtracer_torch.cli view  [--port 8790] [--device cpu]
"""

from .server import ViewerServer, serve
from .session import ViewerSession

__all__ = ["ViewerServer", "ViewerSession", "serve"]
