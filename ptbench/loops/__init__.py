"""Loop kinds: each drives the program's entry points in a closed loop, one
client, from a traffic mix's parameters, and judges what its timed path
produced.

A traffic mix (`traffic/<mix>.json`) names its loop kind under "loop"; the
kind is the module `loops/<loop>.py`, found by name (`manifest.loop`), so a
later mix that needs a new kind of loop brings it as a new file.  A loop
module has

  * `run(run) -> Outcome`: set-up (the scene, every shape the window uses
    warmed), then the window of `run.seconds`, closed loop;
  * `check(config, mix, answers, seed_key, device, control=None) -> dict`:
    {number: value} against the plain reference (`reference/`), run after
    the window once the program's state is freed; `control` puts the
    reference, computed in that precision (`check.DTYPES`), in the
    program's place;
  * `fault(name) -> [(object, attribute, replacement factory)]`: the
    patches that plant one of `faults.FAULTS` under its timed path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Outcome:
    end_to_end: dict  # {metric: value}
    counts: dict  # {"frames": n} or {"steps": n} in the window
    answers: dict  # what the correctness check reads (host data only)


class Orbit:
    """Cameras of an orbit about the configuration's look-at point, at its
    camera's radius and elevation, turned by `phase` radians and then in
    steps of `step_deg`."""

    def __init__(self, camera: dict, phase: float, step_deg: float):
        self.target = np.asarray(camera["look_at"], np.float64)
        off = np.asarray(camera["position"], np.float64) - self.target
        self.radius = float(np.linalg.norm(off))
        self.elevation = math.asin(off[1] / self.radius)
        self.azimuth = math.atan2(off[0], off[2]) + phase
        self.step = math.radians(step_deg)
        self.fov = float(camera["fov"])

    def view(self, j: int) -> dict:
        az, el = self.azimuth + j * self.step, self.elevation
        pos = self.target + self.radius * np.array(
            [math.cos(el) * math.sin(az), math.sin(el), math.cos(el) * math.cos(az)])
        return {"position": [float(x) for x in pos], "look_at": [float(x) for x in self.target],
                "fov": self.fov}


def program_camera(pt, view: dict, device):
    return pt.Camera.create(position=tuple(view["position"]), look_at=tuple(view["look_at"]),
                            fov=view["fov"], device=device)
