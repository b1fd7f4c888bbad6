// Draco mesh codec, from scratch in C++.
//
// The reference vendors Google's Draco decoder as an Emscripten WASM blob
// (reference: public/static/draco/, wired at src/main.ts:258-260) to decode
// KHR_draco_mesh_compression glTF primitives.  This is our native
// equivalent: a bitstream-level implementation of the Draco 2.2 format —
// both directions, so compressed GLBs we export round-trip through our own
// importer and spec-conformant assets in the supported subset decode.
//
// Supported bitstream subset (gated with clear errors otherwise):
//   * encoder_type   TRIANGULAR_MESH (1)
//   * encoder_method MESH_SEQUENTIAL_ENCODING (0) and
//                    MESH_EDGEBREAKER_ENCODING (1) with the standard CLERS
//                    traversal (decode + encode; the encoder covers closed
//                    2-manifold genus-0 meshes and falls back to
//                    sequential otherwise; valence traversal -> error)
//   * connectivity   uncompressed indices (u8/u16/varUI32/u32 by point
//                    count) or the CLERS machine above
//   * attributes     SEQUENTIAL_GENERIC (raw float32) and
//                    SEQUENTIAL_QUANTIZATION / SEQUENTIAL_INTEGER with
//                    PREDICTION_NONE, values raw-width or rANS-coded
//   * no metadata chunk
//
// Conformance caveat: the CLERS bit patterns, rANS layout, and probability
// tables are derived from the public bitstream spec, but byte-level
// conformance against Google's implementation is UNVERIFIABLE in this
// offline image — there is no JS/WASM runtime to execute the vendored
// reference decoder and no network to fetch fixtures.  Validation is by
// encode/decode round-trip on topology-stressing meshes plus structural
// invariants and truncation/bit-flip fuzzing (tests/test_draco.py).
//
// C ABI only; bound from Python via ctypes (tpu_pathtracer/io/draco.py).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <tuple>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

thread_local std::string g_error;

void set_error(const std::string &msg) { g_error = msg; }

// ---------------------------------------------------------------------------
// bitstream reader (bounds checked)
// ---------------------------------------------------------------------------

struct Reader {
  const uint8_t *buf;
  int64_t len;
  int64_t pos = 0;
  bool ok = true;

  bool need(int64_t n) {
    if (!ok || pos + n > len) {
      ok = false;
      set_error("draco: truncated stream at byte " + std::to_string(pos));
      return false;
    }
    return true;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return buf[pos++];
  }
  uint16_t u16() {
    if (!need(2)) return 0;
    uint16_t v = (uint16_t)(buf[pos] | (buf[pos + 1] << 8));
    pos += 2;
    return v;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v;
    std::memcpy(&v, buf + pos, 4);
    pos += 4;
    return v;
  }
  float f32() {
    uint32_t v = u32();
    float f;
    std::memcpy(&f, &v, 4);
    return f;
  }
  uint32_t varu32() {
    uint32_t v = 0;
    int shift = 0;
    for (int i = 0; i < 5; ++i) {
      uint8_t b = u8();
      if (!ok) return 0;
      v |= (uint32_t)(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    set_error("draco: varint longer than 5 bytes");
    return 0;
  }
};

struct Writer {
  std::vector<uint8_t> out;
  void u8(uint8_t v) { out.push_back(v); }
  void u16(uint16_t v) {
    out.push_back((uint8_t)(v & 0xff));
    out.push_back((uint8_t)(v >> 8));
  }
  void u32(uint32_t v) {
    for (int i = 0; i < 4; ++i) out.push_back((uint8_t)((v >> (8 * i)) & 0xff));
  }
  void f32(float f) {
    uint32_t v;
    std::memcpy(&v, &f, 4);
    u32(v);
  }
  void varu32(uint32_t v) {
    while (v >= 0x80) {
      out.push_back((uint8_t)(v | 0x80));
      v >>= 7;
    }
    out.push_back((uint8_t)v);
  }
};

// ---------------------------------------------------------------------------
// decoded representation
// ---------------------------------------------------------------------------

struct Attribute {
  uint32_t unique_id = 0;
  uint8_t att_type = 0;    // 0 POSITION, 1 NORMAL, 2 COLOR, 3 TEX_COORD, 4 GENERIC
  uint8_t data_type = 9;   // DT_FLOAT32
  uint8_t components = 3;
  uint8_t normalized = 0;
  std::vector<float> values;  // num_points * components, dequantized
};

struct DecodedMesh {
  uint32_t num_points = 0;
  uint32_t num_faces = 0;
  std::vector<uint32_t> indices;  // 3 * num_faces
  std::vector<Attribute> attrs;
};

constexpr uint8_t DT_FLOAT32 = 9;
constexpr uint8_t SEQ_GENERIC = 0;
constexpr uint8_t SEQ_INTEGER = 1;
constexpr uint8_t SEQ_QUANTIZATION = 2;
constexpr int8_t PREDICTION_NONE = -2;

int32_t unzigzag(uint32_t u) {
  return (int32_t)((u >> 1) ^ (~(u & 1) + 1));
}
uint32_t zigzag(int32_t v) { return ((uint32_t)v << 1) ^ (uint32_t)(v >> 31); }

// ---------------------------------------------------------------------------
// bit I/O (LSB-first within bytes) — CLERS symbol stream
// ---------------------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t> bytes;
  uint32_t cur = 0;
  int nbits = 0;
  void put(uint32_t bits, int n) {  // n <= 24, LSB-first
    cur |= bits << nbits;
    nbits += n;
    while (nbits >= 8) {
      bytes.push_back((uint8_t)(cur & 0xff));
      cur >>= 8;
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) bytes.push_back((uint8_t)(cur & 0xff));
    cur = 0;
    nbits = 0;
  }
};

struct BitReader {
  const uint8_t *buf;
  int64_t len;
  int64_t byte = 0;
  int bit = 0;
  bool ok = true;
  int get() {  // one bit, LSB-first; 0 on overrun (ok -> false)
    if (byte >= len) {
      ok = false;
      return 0;
    }
    int b = (buf[byte] >> bit) & 1;
    if (++bit == 8) {
      bit = 0;
      ++byte;
    }
    return b;
  }
};

// ---------------------------------------------------------------------------
// rANS entropy coder (Draco-style byte-wise rANS, spec-derived)
//
// State layout follows the public Draco bitstream spec's ans/rans section:
// precision M = 1 << precision_bits, l_rans_base = 4*M, IO_BASE = 256; the
// final state is stored little-endian at the END of the payload with a
// 2-bit length tag in the top bits; state-refill bytes are consumed
// backwards from the front.  Byte-level conformance with Google's coder
// cannot be verified in this offline image (no JS/WASM runtime for the
// vendored reference decoder; no network) — validated by exhaustive
// encode/decode round-trip unit vectors instead (tests/test_draco.py).
// ---------------------------------------------------------------------------

struct RansSym {
  uint32_t prob = 0;
  uint32_t cum = 0;
};

// probs sum to (1 << precision_bits); token-coded per the spec:
//   byte & 3 == 3 -> (byte >> 2) + 1 consecutive zero-prob symbols
//   byte & 3 == t (< 3) -> prob = byte >> 2, extended by t extra bytes
void write_prob_table(Writer &w, const std::vector<uint32_t> &probs) {
  w.varu32((uint32_t)probs.size());
  for (size_t i = 0; i < probs.size();) {
    uint32_t p = probs[i];
    if (p == 0) {
      size_t run = 1;
      while (run < 64 && i + run < probs.size() && probs[i + run] == 0) ++run;
      w.u8((uint8_t)(((run - 1) << 2) | 3));
      i += run;
      continue;
    }
    int extra = p >= (1u << 14) ? 2 : p >= (1u << 6) ? 1 : 0;
    w.u8((uint8_t)(((p & 0x3f) << 2) | extra));
    for (int j = 0; j < extra; ++j) w.u8((uint8_t)((p >> (6 + 8 * j)) & 0xff));
    ++i;
  }
}

bool read_prob_table(Reader &r, uint32_t precision, std::vector<RansSym> &syms,
                     std::vector<uint32_t> &slot_to_sym) {
  uint32_t n = r.varu32();
  if (!r.ok) return false;
  if (n == 0 || n > (1u << 18)) {
    set_error("draco: implausible rANS alphabet size");
    return false;
  }
  syms.assign(n, RansSym{});
  uint64_t total = 0;
  for (uint32_t i = 0; i < n;) {
    uint8_t b = r.u8();
    if (!r.ok) return false;
    if ((b & 3) == 3) {
      uint32_t run = (uint32_t)(b >> 2) + 1;
      if (i + run > n) {
        set_error("draco: rANS zero-prob run past alphabet");
        return false;
      }
      i += run;
      continue;
    }
    uint32_t extra = b & 3;
    uint32_t p = (uint32_t)(b >> 2);
    for (uint32_t j = 0; j < extra; ++j) {
      uint8_t eb = r.u8();
      if (!r.ok) return false;
      p |= (uint32_t)eb << (6 + 8 * j);
    }
    syms[i].prob = p;
    total += p;
    ++i;
  }
  uint64_t M = (uint64_t)1 << precision;
  if (total != M) {
    set_error("draco: rANS probabilities do not sum to 2^precision");
    return false;
  }
  uint32_t cum = 0;
  slot_to_sym.assign((size_t)M, 0);
  for (uint32_t i = 0; i < n; ++i) {
    syms[i].cum = cum;
    for (uint32_t s = 0; s < syms[i].prob; ++s) slot_to_sym[cum + s] = i;
    cum += syms[i].prob;
  }
  return true;
}

// Encode symbols (processed in reverse so the decoder reads forward);
// returns the payload with the tagged final state appended.
std::vector<uint8_t> rans_encode(const std::vector<uint32_t> &symbols,
                                 const std::vector<RansSym> &syms,
                                 uint32_t precision) {
  std::vector<uint8_t> out;
  uint64_t M = (uint64_t)1 << precision;
  uint64_t l_base = M * 4;
  uint64_t state = l_base;
  for (size_t k = symbols.size(); k-- > 0;) {
    const RansSym &s = syms[symbols[k]];
    // emit low bytes until state fits the renormalization interval
    uint64_t upper = ((l_base >> precision) << 8) * s.prob;
    while (state >= upper) {
      out.push_back((uint8_t)(state & 0xff));
      state >>= 8;
    }
    state = (state / s.prob) * M + state % s.prob + s.cum;
  }
  // tagged final state (little-endian at the end, 2-bit size tag in MSBs)
  uint64_t st = state - l_base;
  if (st < (1u << 6)) {
    out.push_back((uint8_t)((0u << 6) | st));
  } else if (st < (1u << 14)) {
    out.push_back((uint8_t)(st & 0xff));
    out.push_back((uint8_t)((1u << 6) | (st >> 8)));
  } else if (st < (1u << 22)) {
    out.push_back((uint8_t)(st & 0xff));
    out.push_back((uint8_t)((st >> 8) & 0xff));
    out.push_back((uint8_t)((2u << 6) | (st >> 16)));
  } else {
    out.push_back((uint8_t)(st & 0xff));
    out.push_back((uint8_t)((st >> 8) & 0xff));
    out.push_back((uint8_t)((st >> 16) & 0xff));
    out.push_back((uint8_t)((3u << 6) | (st >> 24)));
  }
  return out;
}

struct RansDecoder {
  const uint8_t *buf = nullptr;
  int64_t pos = 0;  // refill bytes consumed backwards from the front
  uint64_t state = 0;
  uint64_t M = 0, l_base = 0;
  const std::vector<RansSym> *syms = nullptr;
  const std::vector<uint32_t> *slots = nullptr;
  bool ok = true;

  bool init(const uint8_t *payload, int64_t len, uint32_t precision,
            const std::vector<RansSym> &s, const std::vector<uint32_t> &sl) {
    M = (uint64_t)1 << precision;
    l_base = M * 4;
    syms = &s;
    slots = &sl;
    if (len < 1) {
      set_error("draco: empty rANS payload");
      return false;
    }
    uint8_t tag = payload[len - 1] >> 6;
    int tail = tag + 1;
    if (len < tail) {
      set_error("draco: truncated rANS final state");
      return false;
    }
    uint64_t st = 0;
    for (int i = 0; i < tail; ++i)
      st |= (uint64_t)payload[len - tail + i] << (8 * i);
    st &= ((uint64_t)1 << (6 + 8 * tag)) - 1;
    state = st + l_base;
    buf = payload;
    pos = len - tail;
    return true;
  }
  uint32_t decode() {
    while (state < l_base && pos > 0) state = state * 256 + buf[--pos];
    if (state < l_base) {
      ok = false;
      return 0;
    }
    uint64_t quo = state / M, rem = state % M;
    uint32_t sym = (*slots)[(size_t)rem];
    const RansSym &s = (*syms)[sym];
    state = quo * s.prob + rem - s.cum;
    return sym;
  }
};

// RAW symbol-coding scheme: normalized frequency table + one rANS stream.
void encode_symbols_rans(Writer &w, const std::vector<uint32_t> &symbols) {
  uint32_t maxv = 0;
  for (uint32_t s : symbols) maxv = std::max(maxv, s);
  int max_bl = 1;
  while ((1u << max_bl) <= maxv && max_bl < 31) ++max_bl;
  uint32_t precision = std::min(20, std::max(12, (3 * max_bl) / 2));
  uint32_t n = maxv + 1;
  std::vector<uint64_t> freq(n, 0);
  for (uint32_t s : symbols) freq[s]++;
  uint64_t M = (uint64_t)1 << precision;
  std::vector<uint32_t> probs(n, 0);
  uint64_t total = symbols.size(), used = 0;
  uint32_t argmax = 0;
  for (uint32_t i = 0; i < n; ++i) {
    if (!freq[i]) continue;
    probs[i] = (uint32_t)std::max<uint64_t>(1, freq[i] * M / total);
    used += probs[i];
    if (probs[i] > probs[argmax]) argmax = i;
  }
  // fix rounding drift on the most probable symbol (keeps every used
  // symbol's probability >= 1)
  int64_t drift = (int64_t)M - (int64_t)used;
  if ((int64_t)probs[argmax] + drift < 1) {  // pathological skew: flatten
    for (uint32_t i = 0; i < n; ++i) probs[i] = freq[i] ? 1 : 0;
    uint64_t base = 0;
    for (uint32_t i = 0; i < n; ++i) base += probs[i];
    probs[argmax] += (uint32_t)(M - base);
  } else {
    probs[argmax] = (uint32_t)((int64_t)probs[argmax] + drift);
  }
  w.u8(1);  // RAW scheme
  w.u8((uint8_t)precision);
  write_prob_table(w, probs);
  std::vector<RansSym> syms(n);
  uint32_t cum = 0;
  for (uint32_t i = 0; i < n; ++i) {
    syms[i].prob = probs[i];
    syms[i].cum = cum;
    cum += probs[i];
  }
  std::vector<uint8_t> payload = rans_encode(symbols, syms, precision);
  w.varu32((uint32_t)payload.size());
  w.out.insert(w.out.end(), payload.begin(), payload.end());
}

bool decode_symbols_rans(Reader &r, uint64_t count,
                         std::vector<uint32_t> &out) {
  uint8_t scheme = r.u8();
  if (!r.ok) return false;
  if (scheme != 1) {
    set_error("draco: only the RAW rANS symbol scheme is supported (got " +
              std::to_string(scheme) + ")");
    return false;
  }
  uint8_t precision = r.u8();
  if (!r.ok) return false;
  if (precision < 1 || precision > 20) {
    set_error("draco: bad rANS precision " + std::to_string(precision));
    return false;
  }
  std::vector<RansSym> syms;
  std::vector<uint32_t> slots;
  if (!read_prob_table(r, precision, syms, slots)) return false;
  uint32_t payload_len = r.varu32();
  if (!r.ok || !r.need(payload_len)) return false;
  RansDecoder d;
  if (!d.init(r.buf + r.pos, payload_len, precision, syms, slots))
    return false;
  r.pos += payload_len;
  out.resize(count);
  for (uint64_t k = 0; k < count; ++k) {
    out[k] = d.decode();
    if (!d.ok) {
      set_error("draco: rANS stream exhausted mid-decode");
      return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Edgebreaker connectivity (standard CLERS traversal)
//
// Decoder: reverse play ("spirale reversi" family) over the CLERS string,
// which our encoder stores in reverse conquest order.  Active boundary
// loops are circular doubly-linked vertex lists; S-merges unify the shared
// split vertex.  Bit patterns follow the spec's standard traversal:
// C = 0 (1 bit); otherwise 1 + two bits selecting S/L/R/E.
// Supported topology: closed 2-manifold components of genus 0 (the encoder
// falls back to the sequential method otherwise — see encode_stream).
// ---------------------------------------------------------------------------

enum ClersSym : uint8_t { SYM_C = 0, SYM_S = 1, SYM_L = 2, SYM_R = 3,
                          SYM_E = 4 };

struct LoopState {
  // circular doubly-linked boundary loops over vertex ids
  std::vector<int32_t> nxt, prv;
  std::vector<int32_t> alias;  // S-merge unification: slot -> absorbing id
  int32_t gate_a = -1, gate_b = -1;  // current loop's gate edge a->b
  std::vector<std::pair<int32_t, int32_t>> stack;  // pushed loops' gates

  int32_t new_vertex() {
    nxt.push_back(-1);
    prv.push_back(-1);
    alias.push_back(-1);
    return (int32_t)nxt.size() - 1;
  }
  void link(int32_t u, int32_t v) {
    nxt[u] = v;
    prv[v] = u;
  }
  int32_t resolve(int32_t v) const {  // follow alias chain (S-merges)
    while (alias[v] >= 0) v = alias[v];
    return v;
  }
};

// Decode one component's CLERS string (symbols in reverse conquest order)
// into faces; vertex ids are assigned in decode order.  Returns false with
// set_error on malformed input.  `budget` bounds total vertex creation.
bool decode_clers(BitReader &bits, uint32_t num_symbols,
                  std::vector<uint32_t> &faces, LoopState &st,
                  uint32_t budget) {
  for (uint32_t i = 0; i < num_symbols; ++i) {
    int lead = bits.get();
    uint8_t sym;
    if (!lead) {
      sym = SYM_C;
    } else {
      int b0 = bits.get(), b1 = bits.get();
      sym = (uint8_t)(SYM_S + (b0 | (b1 << 1)));
    }
    if (!bits.ok) {
      set_error("draco: CLERS bitstream truncated");
      return false;
    }
    switch (sym) {
      case SYM_E: {  // reverse of E: fresh 3-cycle becomes current loop
        if ((uint32_t)st.nxt.size() + 3 > budget) {
          set_error("draco: edgebreaker vertex budget exceeded");
          return false;
        }
        if (st.gate_a >= 0) st.stack.push_back({st.gate_a, st.gate_b});
        int32_t a = st.new_vertex(), b = st.new_vertex(),
                c = st.new_vertex();
        st.link(a, b);
        st.link(b, c);
        st.link(c, a);
        st.gate_a = a;
        st.gate_b = b;
        faces.push_back(b);
        faces.push_back(a);
        faces.push_back(c);
        break;
      }
      case SYM_R: {  // reverse of R: insert new b between gate (a, c)
        if (st.gate_a < 0 || (uint32_t)st.nxt.size() + 1 > budget) {
          set_error("draco: malformed CLERS stream (R)");
          return false;
        }
        int32_t a = st.gate_a, c = st.gate_b;
        int32_t b = st.new_vertex();
        st.link(a, b);
        st.link(b, c);
        st.gate_b = b;
        faces.push_back(b);
        faces.push_back(a);
        faces.push_back(c);
        break;
      }
      case SYM_L: {  // reverse of L: insert new a between gate (z, b)
        if (st.gate_a < 0 || (uint32_t)st.nxt.size() + 1 > budget) {
          set_error("draco: malformed CLERS stream (L)");
          return false;
        }
        int32_t z = st.gate_a, b = st.gate_b;
        int32_t a = st.new_vertex();
        st.link(z, a);
        st.link(a, b);
        st.gate_a = a;
        faces.push_back(b);
        faces.push_back(a);
        faces.push_back(z);
        break;
      }
      case SYM_C: {  // reverse of C: remove gate.a (= forward's new v)
        if (st.gate_a < 0) {
          set_error("draco: malformed CLERS stream (C)");
          return false;
        }
        int32_t v = st.gate_a, b = st.gate_b;
        int32_t a = st.prv[v];
        if (a == b || a == v) {  // loop would degenerate below 3 vertices
          set_error("draco: degenerate loop in CLERS stream (C)");
          return false;
        }
        st.link(a, b);
        st.nxt[v] = st.prv[v] = v;  // v complete (interior)
        st.gate_a = a;
        faces.push_back(b);
        faces.push_back(a);
        faces.push_back(v);
        break;
      }
      case SYM_S: {  // reverse of S: merge current with stacked loop at v
        if (st.gate_a < 0 || st.stack.empty()) {
          set_error("draco: malformed CLERS stream (S: no stacked loop)");
          return false;
        }
        int32_t v = st.gate_a, b = st.gate_b;  // current gate (v, b)
        auto [a, v2] = st.stack.back();        // stacked gate (a, v2)
        st.stack.pop_back();
        // unify v2 with v: v2's links transfer to v, then splice
        // cycle C2 (.. -> a -> v2 -> w ..) into the current one
        int32_t w = st.nxt[v2];
        if (w == v2 || a == v2) {
          set_error("draco: degenerate stacked loop in CLERS stream (S)");
          return false;
        }
        st.link(v, w);  // v takes over v2's outgoing edge
        st.link(a, b);  // close the merged cycle across the gate
        // v2 is the stacked loop's label for the same split vertex:
        // faces emitted during that loop's rewind reference it, so it is
        // remapped (not just retired) in the final alias-resolution pass.
        st.alias[v2] = v;
        st.nxt[v2] = st.prv[v2] = -2;
        st.gate_a = a;
        faces.push_back(b);
        faces.push_back(a);
        faces.push_back(v);
        break;
      }
    }
  }
  return true;
}

bool finalize_component(LoopState &st, std::vector<uint32_t> &faces) {
  // remaining loop must be exactly a 3-cycle: the conquest's start face
  if (st.gate_a < 0 || !st.stack.empty()) {
    set_error("draco: CLERS stream left no closable start loop");
    return false;
  }
  int32_t a = st.gate_a, b = st.gate_b, c = st.nxt[b];
  if (st.nxt[a] != b || c == a || st.nxt[c] != a) {
    set_error("draco: CLERS stream does not close to a triangle");
    return false;
  }
  faces.push_back(a);
  faces.push_back(b);
  faces.push_back(c);
  st.gate_a = st.gate_b = -1;
  return true;
}

// Full edgebreaker connectivity decode: header, per-component CLERS
// strings, alias resolution, creation-order vertex compaction.
bool decode_edgebreaker_connectivity(Reader &r, DecodedMesh &mesh) {
  uint8_t trav = r.u8();
  if (!r.ok) return false;
  if (trav != 0) {
    set_error("draco: only the standard edgebreaker traversal is supported "
              "(got traversal type " + std::to_string(trav) + ")");
    return false;
  }
  uint32_t num_points = r.varu32();
  uint32_t num_faces = r.varu32();
  uint32_t num_comp = r.varu32();
  if (!r.ok) return false;
  if ((int64_t)num_faces > r.len * 8 || (int64_t)num_points > r.len * 8 ||
      num_comp == 0 || num_comp > num_faces) {
    set_error("draco: implausible edgebreaker header counts");
    return false;
  }
  std::vector<uint32_t> nsym(num_comp);
  uint64_t total_sym = 0;
  for (uint32_t c = 0; c < num_comp; ++c) {
    nsym[c] = r.varu32();
    total_sym += nsym[c];
  }
  if (!r.ok) return false;
  if (total_sym + num_comp != num_faces) {
    set_error("draco: edgebreaker symbol count mismatch");
    return false;
  }
  uint32_t clers_len = r.varu32();
  if (!r.ok || !r.need(clers_len)) return false;
  BitReader bits{r.buf + r.pos, clers_len};
  r.pos += clers_len;

  LoopState st;
  std::vector<uint32_t> faces;
  faces.reserve((size_t)num_faces * 3);
  uint32_t budget = num_points + num_faces;  // aliases add <= one per S
  for (uint32_t c = 0; c < num_comp; ++c) {
    if (!decode_clers(bits, nsym[c], faces, st, budget)) return false;
    if (!finalize_component(st, faces)) return false;
  }
  // compact: creation-order ids, alias slots resolved then skipped
  std::vector<int32_t> remap(st.nxt.size(), -1);
  uint32_t used = 0;
  for (size_t s = 0; s < st.nxt.size(); ++s)
    if (st.alias[s] < 0) remap[s] = (int32_t)used++;
  if (used != num_points) {
    set_error("draco: edgebreaker vertex count mismatch (stream says " +
              std::to_string(num_points) + ", decoded " +
              std::to_string(used) + ")");
    return false;
  }
  mesh.num_points = num_points;
  mesh.num_faces = num_faces;
  mesh.indices.resize(faces.size());
  for (size_t i = 0; i < faces.size(); ++i)
    mesh.indices[i] = (uint32_t)remap[st.resolve((int32_t)faces[i])];
  return true;
}

// ---------------------------------------------------------------------------
// Edgebreaker encoder: forward conquest over an explicit boundary-loop
// machine (split vertices get copy slots, mirroring the decoder's aliases).
// Returns false for topologies outside the supported subset (boundary,
// non-manifold, genus > 0, unreferenced vertices) — the caller then falls
// back to the sequential method.
// ---------------------------------------------------------------------------

struct EbEncoded {
  std::vector<uint32_t> comp_nsym;
  std::vector<uint8_t> clers;          // packed bits, reversed per component
  std::vector<int32_t> vperm;          // decoder vertex id -> original id
  uint32_t num_faces = 0, num_points = 0;
};

bool edgebreaker_encode_connectivity(int64_t n, const uint32_t *idx,
                                     int64_t f, EbEncoded &enc,
                                     std::string *why) {
  auto fail = [&](const char *msg) {
    if (why) *why = msg;
    return false;
  };
  // directed edge map: (u -> v) -> face; closed manifold needs each
  // directed edge exactly once and both directions present
  std::unordered_map<uint64_t, int32_t> dedge;
  dedge.reserve((size_t)f * 3 * 2);
  auto dkey = [](uint32_t u, uint32_t v) {
    return ((uint64_t)u << 32) | v;
  };
  for (int64_t t = 0; t < f; ++t) {
    const uint32_t *tri = idx + 3 * t;
    if (tri[0] == tri[1] || tri[1] == tri[2] || tri[0] == tri[2])
      return fail("degenerate face");
    for (int e = 0; e < 3; ++e) {
      uint64_t k = dkey(tri[e], tri[(e + 1) % 3]);
      if (!dedge.emplace(k, (int32_t)t).second)
        return fail("non-manifold edge (duplicate directed edge)");
    }
  }
  for (const auto &kv : dedge) {
    uint32_t u = (uint32_t)(kv.first >> 32), v = (uint32_t)kv.first;
    if (!dedge.count(dkey(v, u))) return fail("open boundary edge");
  }
  std::vector<uint8_t> vref(n, 0);
  for (int64_t i = 0; i < 3 * f; ++i) vref[idx[i]] = 1;
  for (int64_t v = 0; v < n; ++v)
    if (!vref[v]) return fail("unreferenced vertex");

  // boundary machine state: slots (original vertices + split copies)
  std::vector<int32_t> nxt(n, -1), prv(n, -1), orig(n), loop_of(n, -1);
  std::vector<uint8_t> visited(n, 0), conquered(f, 0);
  for (int64_t v = 0; v < n; ++v) orig[v] = (int32_t)v;
  // active slots per original vertex (split copies are rare)
  std::unordered_map<int32_t, std::vector<int32_t>> extra_slots;
  auto slot_on_loop = [&](int32_t v, int32_t loop) -> int32_t {
    if (loop_of[v] == loop) return v;  // primary slot
    auto it = extra_slots.find(v);
    if (it != extra_slots.end())
      for (int32_t s : it->second)
        if (loop_of[s] == loop) return s;
    return -1;
  };
  auto new_slot = [&](int32_t orig_v) {
    nxt.push_back(-1);
    prv.push_back(-1);
    orig.push_back(orig_v);
    loop_of.push_back(-1);
    int32_t s = (int32_t)nxt.size() - 1;
    extra_slots[orig_v].push_back(s);
    return s;
  };
  auto link = [&](int32_t u, int32_t v) {
    nxt[u] = v;
    prv[v] = u;
  };

  std::vector<uint8_t> symbols;                    // conquest order
  std::vector<std::array<int32_t, 3>> expected;    // decoder-order triples
  std::vector<std::array<int32_t, 3>> comp_faces;  // this comp, conquest order
  std::vector<std::pair<int32_t, int32_t>> stack;  // pushed loops' gates
  int32_t next_loop_id = 0;
  int64_t conquered_n = 0;
  BitWriter bw;

  for (int64_t start = 0; start < f; ++start) {
    if (conquered[start]) continue;
    // new component: seed the loop with the start face's own orientation
    const uint32_t *tri = idx + 3 * start;
    int32_t p = (int32_t)tri[0], q = (int32_t)tri[1], rr = (int32_t)tri[2];
    int32_t loop = next_loop_id++;
    link(p, q);
    link(q, rr);
    link(rr, p);
    loop_of[p] = loop_of[q] = loop_of[rr] = loop;
    visited[p] = visited[q] = visited[rr] = 1;
    conquered[start] = 1;
    ++conquered_n;
    int32_t ga = p, gb = q;  // gate a->b
    comp_faces.clear();
    size_t sym_base = symbols.size();
    comp_faces.push_back({p, q, rr});  // start face (cyclic match at align)
    bool comp_done = false;
    while (!comp_done) {
      // unconquered face across gate edge contains directed (orig b -> orig a)
      auto it = dedge.find(dkey((uint32_t)orig[gb], (uint32_t)orig[ga]));
      if (it == dedge.end()) return fail("machine hit missing edge");
      int32_t face = it->second;
      if (conquered[face]) return fail("machine revisited a face");
      const uint32_t *ft = idx + 3 * face;
      int32_t v = -1;
      for (int e = 0; e < 3; ++e)
        if ((int32_t)ft[e] != orig[ga] && (int32_t)ft[e] != orig[gb])
          v = (int32_t)ft[e];
      if (v < 0) return fail("degenerate adjacent face");
      conquered[face] = 1;
      ++conquered_n;
      comp_faces.push_back({orig[gb], orig[ga], v});
      int32_t rn = nxt[gb], ln = prv[ga];
      if (rn == ga ? false : (nxt[rn] == ga && orig[rn] == v &&
                              prv[ga] == rn)) {
        // loop is exactly {ga, gb, rn}: E
        symbols.push_back(SYM_E);
        loop_of[ga] = loop_of[gb] = loop_of[rn] = -1;
        if (stack.empty()) {
          comp_done = true;
        } else {
          std::tie(ga, gb) = stack.back();
          stack.pop_back();
          loop = loop_of[ga];
        }
      } else if (orig[rn] == v) {  // R: right neighbor consumed
        symbols.push_back(SYM_R);
        loop_of[gb] = -1;
        link(ga, rn);
        gb = rn;
      } else if (orig[ln] == v) {  // L: left neighbor consumed
        symbols.push_back(SYM_L);
        loop_of[ga] = -1;
        link(ln, gb);
        ga = ln;
      } else if (!visited[v]) {  // C: new vertex into the boundary
        symbols.push_back(SYM_C);
        visited[v] = 1;
        if (loop_of[v] != -1) return fail("vertex slot already active");
        link(ga, v);
        link(v, gb);
        loop_of[v] = loop;
        ga = v;
      } else {
        int32_t sv = slot_on_loop(v, loop);
        if (sv < 0)
          return fail("split vertex not on current loop (genus > 0 or "
                      "non-manifold vertex)");
        // S: split.  C2 takes a copy slot for v; C1 keeps sv.
        symbols.push_back(SYM_S);
        int32_t w = nxt[sv];
        int32_t vc = new_slot(v);
        link(vc, w);
        link(ga, vc);
        link(sv, gb);
        // retag C2 (the pushed loop a->vc->w->..)
        int32_t l2 = next_loop_id++;
        for (int32_t s = vc;;) {
          loop_of[s] = l2;
          s = nxt[s];
          if (s == vc) break;
        }
        stack.push_back({ga, vc});
        ga = sv;
      }
    }
    // expected triples in decoder order: reversed symbol faces, then f0
    uint32_t m = (uint32_t)comp_faces.size();
    for (uint32_t j = 0; j < m - 1; ++j)
      expected.push_back(comp_faces[m - 1 - j]);
    expected.push_back(comp_faces[0]);
    enc.comp_nsym.push_back((uint32_t)(symbols.size() - sym_base));
    // bit-pack this component's symbols in reverse conquest order
    for (size_t s = symbols.size(); s-- > sym_base;) {
      uint8_t sym = symbols[s];
      if (sym == SYM_C)
        bw.put(0, 1);
      else
        bw.put(1u | ((uint32_t)(sym - SYM_S) << 1), 3);
    }
  }
  if (conquered_n != f) return fail("not all faces conquered");
  bw.flush();
  enc.clers = std::move(bw.bytes);
  enc.num_faces = (uint32_t)f;
  enc.num_points = (uint32_t)n;

  // self-validation: run the real decoder on the produced stream and align
  // its faces with the expected triples to derive the vertex permutation
  BitReader br{enc.clers.data(), (int64_t)enc.clers.size()};
  LoopState st;
  std::vector<uint32_t> dfaces;
  for (uint32_t c = 0; c < enc.comp_nsym.size(); ++c) {
    if (!decode_clers(br, enc.comp_nsym[c], dfaces, st,
                      enc.num_points + enc.num_faces))
      return fail("self-decode failed");
    if (!finalize_component(st, dfaces)) return fail("self-decode failed");
  }
  if (dfaces.size() != expected.size() * 3)
    return fail("self-decode face count mismatch");
  std::vector<int32_t> remap(st.nxt.size(), -1);
  int32_t used = 0;
  for (size_t s = 0; s < st.nxt.size(); ++s)
    if (st.alias[s] < 0) remap[s] = used++;
  if (used != (int32_t)n) return fail("self-decode vertex count mismatch");
  enc.vperm.assign((size_t)n, -1);
  std::vector<int32_t> seen(n, 0);
  // start faces (each component's last decoder face) match cyclically;
  // symbol faces match positionally (both sides emit (b, a, v))
  std::vector<uint8_t> is_start(expected.size(), 0);
  {
    size_t base = 0;
    for (uint32_t c = 0; c < enc.comp_nsym.size(); ++c) {
      base += enc.comp_nsym[c] + 1;
      is_start[base - 1] = 1;
    }
  }
  for (size_t k = 0; k < expected.size(); ++k) {
    int32_t d[3];
    for (int e = 0; e < 3; ++e)
      d[e] = remap[st.resolve((int32_t)dfaces[3 * k + e])];
    const auto &ex = expected[k];
    int rots = is_start[k] ? 3 : 1;
    bool okr = false;
    for (int rot = 0; rot < rots && !okr; ++rot) {
      bool consistent = true;
      for (int e = 0; e < 3; ++e) {
        int32_t dv = d[e], ov = ex[(e + rot) % 3];
        if (enc.vperm[dv] >= 0 && enc.vperm[dv] != ov) consistent = false;
      }
      if (!consistent) continue;
      for (int e = 0; e < 3; ++e) enc.vperm[d[e]] = ex[(e + rot) % 3];
      okr = true;
    }
    if (!okr) return fail("self-decode face alignment failed");
  }
  for (int64_t v = 0; v < n; ++v)
    if (enc.vperm[v] < 0) return fail("self-decode left unmapped vertices");
  // every original vertex must be hit exactly once
  for (int64_t v = 0; v < n; ++v) seen[enc.vperm[v]]++;
  for (int64_t v = 0; v < n; ++v)
    if (seen[v] != 1) return fail("vertex permutation not a bijection");
  return true;
}

// ---------------------------------------------------------------------------
// decoder
// ---------------------------------------------------------------------------

bool decode_stream(const uint8_t *buf, int64_t len, DecodedMesh &mesh) {
  Reader r{buf, len};
  if (!r.need(8)) return false;
  if (std::memcmp(buf, "DRACO", 5) != 0) {
    set_error("draco: bad magic (not a Draco stream)");
    return false;
  }
  r.pos = 5;
  uint8_t major = r.u8(), minor = r.u8();
  if (major != 2) {
    set_error("draco: unsupported bitstream major version " +
              std::to_string(major) + "." + std::to_string(minor));
    return false;
  }
  uint8_t enc_type = r.u8();
  uint8_t method = r.u8();
  uint16_t flags = r.u16();
  if (enc_type != 1) {
    set_error("draco: only TRIANGULAR_MESH streams supported (got type " +
              std::to_string(enc_type) + ")");
    return false;
  }
  if (method != 0 && method != 1) {
    set_error("draco: unknown encoding method " + std::to_string(method));
    return false;
  }
  if (flags & 0x8000) {
    set_error("draco: metadata chunk not supported");
    return false;
  }

  if (method == 1) {
    // --- edgebreaker connectivity ----------------------------------------
    if (!decode_edgebreaker_connectivity(r, mesh)) return false;
  } else {
    // --- sequential connectivity -----------------------------------------
    mesh.num_faces = r.varu32();
    mesh.num_points = r.varu32();
    if (!r.ok) return false;
    if ((int64_t)mesh.num_faces * 3 > len * 8) {  // sanity vs stream size
      set_error("draco: face count implausible for stream size");
      return false;
    }
    uint8_t conn_method = r.u8();
    if (conn_method != 1) {
      set_error("draco: compressed (rANS) connectivity not supported");
      return false;
    }
    uint64_t n_idx = (uint64_t)mesh.num_faces * 3;
    mesh.indices.resize(n_idx);
    if (mesh.num_points < (1u << 8)) {
      for (uint64_t i = 0; i < n_idx; ++i) mesh.indices[i] = r.u8();
    } else if (mesh.num_points < (1u << 16)) {
      for (uint64_t i = 0; i < n_idx; ++i) mesh.indices[i] = r.u16();
    } else if (mesh.num_points < (1u << 21)) {
      for (uint64_t i = 0; i < n_idx; ++i) mesh.indices[i] = r.varu32();
    } else {
      for (uint64_t i = 0; i < n_idx; ++i) mesh.indices[i] = r.u32();
    }
    if (!r.ok) return false;
    for (uint64_t i = 0; i < n_idx; ++i)
      if (mesh.indices[i] >= mesh.num_points) {
        set_error("draco: vertex index out of range");
        return false;
      }
  }

  // --- attributes ---------------------------------------------------------
  // Plausibility: every point must carry at least one byte of attribute
  // data somewhere in the stream, so num_points bounded by the remaining
  // bytes (mirrors the num_faces check above).  Without this a ~40-byte
  // crafted stream claiming 2^32-2 points forces a multi-GB zero-fill
  // before any per-value bounds check runs (advisor finding, round 1).
  if ((int64_t)mesh.num_points > len) {
    set_error("draco: point count implausible for stream size");
    return false;
  }
  uint8_t n_decoders = r.u8();
  if (!r.ok) return false;
  for (uint8_t d = 0; d < n_decoders; ++d) {
    uint32_t n_attrs = r.varu32();
    if (!r.ok) return false;
    if (n_attrs > 64) {
      set_error("draco: implausible attribute count");
      return false;
    }
    size_t first = mesh.attrs.size();
    for (uint32_t j = 0; j < n_attrs; ++j) {
      Attribute a;
      a.att_type = r.u8();
      a.data_type = r.u8();
      a.components = r.u8();
      a.normalized = r.u8();
      a.unique_id = r.varu32();
      if (!r.ok) return false;
      if (a.components == 0 || a.components > 4) {
        set_error("draco: unsupported component count " +
                  std::to_string(a.components));
        return false;
      }
      mesh.attrs.push_back(a);
    }
    std::vector<uint8_t> dec_types(n_attrs);
    for (uint32_t j = 0; j < n_attrs; ++j) dec_types[j] = r.u8();
    if (!r.ok) return false;

    // per-attribute portable data
    struct QInfo {
      bool quantized = false;
      std::vector<uint32_t> symbols;
    };
    std::vector<QInfo> qinfo(n_attrs);
    for (uint32_t j = 0; j < n_attrs; ++j) {
      Attribute &a = mesh.attrs[first + j];
      uint64_t n_vals = (uint64_t)mesh.num_points * a.components;
      uint8_t dt = dec_types[j];
      if (dt == SEQ_GENERIC) {
        if (a.data_type != DT_FLOAT32) {
          set_error("draco: generic attribute with non-float32 data type " +
                    std::to_string(a.data_type) + " not supported");
          return false;
        }
        if (!r.need((int64_t)n_vals * 4)) return false;  // bounds BEFORE alloc
        a.values.resize(n_vals);
        std::memcpy(a.values.data(), r.buf + r.pos, n_vals * 4);
        r.pos += (int64_t)n_vals * 4;
      } else if (dt == SEQ_INTEGER || dt == SEQ_QUANTIZATION) {
        int8_t pred = (int8_t)r.u8();
        if (!r.ok) return false;
        if (pred != PREDICTION_NONE) {
          set_error("draco: prediction scheme " + std::to_string(pred) +
                    " not supported (only PREDICTION_NONE)");
          return false;
        }
        uint8_t compressed = r.u8();
        if (!r.ok) return false;
        qinfo[j].quantized = (dt == SEQ_QUANTIZATION);
        if (compressed == 1) {
          // rANS-coded zigzag symbols (the spec's compressed value path)
          if (n_vals > (uint64_t)len * 64) {  // >=1 bit of payload per value
            set_error("draco: value count implausible for stream size");
            return false;
          }
          std::vector<uint32_t> zz;
          if (!decode_symbols_rans(r, n_vals, zz)) return false;
          qinfo[j].symbols.resize(n_vals);
          for (uint64_t k = 0; k < n_vals; ++k)
            qinfo[j].symbols[k] = (uint32_t)unzigzag(zz[k]);
        } else if (compressed == 0) {
          uint8_t nbytes = r.u8();
          if (!r.ok) return false;
          if (nbytes != 1 && nbytes != 2 && nbytes != 4) {
            set_error("draco: unsupported integer width " +
                      std::to_string(nbytes));
            return false;
          }
          // every value occupies exactly `nbytes` in the stream: bound the
          // allocation by the remaining bytes before sizing the buffer
          if (!r.need((int64_t)n_vals * nbytes)) return false;
          qinfo[j].symbols.resize(n_vals);
          for (uint64_t k = 0; k < n_vals; ++k) {
            uint32_t raw =
                nbytes == 1 ? r.u8() : nbytes == 2 ? r.u16() : r.u32();
            // PREDICTION_NONE stores zigzagged signed symbols
            qinfo[j].symbols[k] = (uint32_t)unzigzag(raw);
          }
          if (!r.ok) return false;
        } else {
          set_error("draco: unknown value-compression flag " +
                    std::to_string(compressed));
          return false;
        }
        if (dt == SEQ_INTEGER) {
          a.values.resize(n_vals);
          for (uint64_t k = 0; k < n_vals; ++k)
            a.values[k] = (float)(int32_t)qinfo[j].symbols[k];
        }
      } else {
        set_error("draco: sequential attribute decoder type " +
                  std::to_string(dt) + " not supported");
        return false;
      }
    }
    // transform data (after portable values, per spec ordering)
    for (uint32_t j = 0; j < n_attrs; ++j) {
      if (dec_types[j] != SEQ_QUANTIZATION) continue;
      Attribute &a = mesh.attrs[first + j];
      std::vector<float> mins(a.components);
      for (uint32_t c = 0; c < a.components; ++c) mins[c] = r.f32();
      float range = r.f32();
      uint8_t qbits = r.u8();
      if (!r.ok) return false;
      if (qbits == 0 || qbits > 30) {
        set_error("draco: bad quantization bit count " + std::to_string(qbits));
        return false;
      }
      double scale = (double)range / (double)((1u << qbits) - 1);
      uint64_t n_vals = (uint64_t)mesh.num_points * a.components;
      a.values.resize(n_vals);
      for (uint64_t k = 0; k < n_vals; ++k) {
        uint32_t c = (uint32_t)(k % a.components);
        a.values[k] =
            (float)(mins[c] + (double)(int32_t)qinfo[j].symbols[k] * scale);
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// encoder
// ---------------------------------------------------------------------------

void encode_attr_header(Writer &w, uint8_t att_type, uint8_t components,
                        uint32_t unique_id) {
  w.u8(att_type);
  w.u8(DT_FLOAT32);
  w.u8(components);
  w.u8(0);  // normalized
  w.varu32(unique_id);
}

void encode_attr_values(Writer &w, const float *vals, uint64_t n_points,
                        uint32_t components, int qbits,
                        bool rans_values = false) {
  uint64_t n_vals = n_points * components;
  if (qbits <= 0) {  // generic raw float32
    size_t off = w.out.size();
    w.out.resize(off + n_vals * 4);
    std::memcpy(w.out.data() + off, vals, n_vals * 4);
    return;
  }
  // quantization: portable integer part first, transform data after
  std::vector<float> mins(components, INFINITY);
  std::vector<float> maxs(components, -INFINITY);
  for (uint64_t k = 0; k < n_vals; ++k) {
    uint32_t c = (uint32_t)(k % components);
    mins[c] = std::min(mins[c], vals[k]);
    maxs[c] = std::max(maxs[c], vals[k]);
  }
  float range = 0.f;
  for (uint32_t c = 0; c < components; ++c)
    range = std::max(range, maxs[c] - mins[c]);
  if (!(range > 0.f)) range = 1.f;
  uint32_t maxq = (1u << qbits) - 1;
  double inv_scale = (double)maxq / (double)range;

  w.u8((uint8_t)PREDICTION_NONE);
  std::vector<uint32_t> zz(n_vals);
  for (uint64_t k = 0; k < n_vals; ++k) {
    uint32_t c = (uint32_t)(k % components);
    double q = ((double)vals[k] - (double)mins[c]) * inv_scale;
    int32_t qi = (int32_t)std::lround(q);
    if (qi < 0) qi = 0;
    if ((uint32_t)qi > maxq) qi = (int32_t)maxq;
    zz[k] = zigzag(qi);
  }
  if (rans_values) {
    w.u8(1);  // rANS-compressed symbols
    encode_symbols_rans(w, zz);
  } else {
    w.u8(0);  // not compressed
    uint8_t nbytes = qbits <= 7 ? 1 : qbits <= 15 ? 2 : 4;
    w.u8(nbytes);
    for (uint64_t k = 0; k < n_vals; ++k) {
      if (nbytes == 1)
        w.u8((uint8_t)zz[k]);
      else if (nbytes == 2)
        w.u16((uint16_t)zz[k]);
      else
        w.u32(zz[k]);
    }
  }
  // transform data
  for (uint32_t c = 0; c < components; ++c) w.f32(mins[c]);
  w.f32(range);
  w.u8((uint8_t)qbits);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
//
// Every entry point is wrapped so C++ exceptions (std::bad_alloc above all)
// never cross the ctypes boundary — an escaping exception through extern "C"
// calls std::terminate and takes the Python interpreter down with it
// (advisor finding, round 1).
// ---------------------------------------------------------------------------

namespace {

template <typename Fn>
int64_t guarded(Fn &&fn) noexcept {
  try {
    return fn();
  } catch (const std::exception &e) {
    set_error(std::string("draco: internal error: ") + e.what());
    return -1;
  } catch (...) {
    set_error("draco: unknown internal error");
    return -1;
  }
}

}  // namespace

extern "C" {

const char *tpu_pt_draco_last_error() { return g_error.c_str(); }

// --- decode-to-handle API: one full parse, then cheap accessor reads ------

// Returns an opaque handle (free with tpu_pt_draco_close) or NULL on error.
void *tpu_pt_draco_open(const uint8_t *buf, int64_t len) {
  void *out = nullptr;
  guarded([&]() -> int64_t {
    auto m = new DecodedMesh();
    if (!decode_stream(buf, len, *m)) {
      delete m;
      return -1;
    }
    out = m;
    return 0;
  });
  return out;
}

void tpu_pt_draco_close(void *h) {
  delete static_cast<DecodedMesh *>(h);
}

// info[0]=num_points, info[1]=num_faces, info[2]=num_attributes
int64_t tpu_pt_draco_h_info(void *h, int64_t *info) {
  return guarded([&]() -> int64_t {
    const auto &m = *static_cast<DecodedMesh *>(h);
    info[0] = m.num_points;
    info[1] = m.num_faces;
    info[2] = (int64_t)m.attrs.size();
    return 0;
  });
}

// out[0]=unique_id, out[1]=att_type, out[2]=data_type, out[3]=components
int64_t tpu_pt_draco_h_attr_info(void *h, int64_t j, int64_t *out) {
  return guarded([&]() -> int64_t {
    const auto &m = *static_cast<DecodedMesh *>(h);
    if (j < 0 || j >= (int64_t)m.attrs.size()) {
      set_error("draco: attribute index out of range");
      return -1;
    }
    out[0] = m.attrs[j].unique_id;
    out[1] = m.attrs[j].att_type;
    out[2] = m.attrs[j].data_type;
    out[3] = m.attrs[j].components;
    return 0;
  });
}

// out must hold 3*num_faces uint32
int64_t tpu_pt_draco_h_indices(void *h, uint32_t *out) {
  return guarded([&]() -> int64_t {
    const auto &m = *static_cast<DecodedMesh *>(h);
    std::memcpy(out, m.indices.data(), m.indices.size() * 4);
    return (int64_t)m.indices.size();
  });
}

// out must hold num_points*components float32 for attribute j
int64_t tpu_pt_draco_h_attr_f32(void *h, int64_t j, float *out) {
  return guarded([&]() -> int64_t {
    const auto &m = *static_cast<DecodedMesh *>(h);
    if (j < 0 || j >= (int64_t)m.attrs.size()) {
      set_error("draco: attribute index out of range");
      return -1;
    }
    const Attribute &a = m.attrs[j];
    std::memcpy(out, a.values.data(), a.values.size() * 4);
    return (int64_t)a.values.size();
  });
}

// --- legacy one-shot API (kept for compatibility; each call re-parses) ----

// info[0]=num_points, info[1]=num_faces, info[2]=num_attributes
int64_t tpu_pt_draco_info(const uint8_t *buf, int64_t len, int64_t *info) {
  return guarded([&]() -> int64_t {
    DecodedMesh m;
    if (!decode_stream(buf, len, m)) return -1;
    info[0] = m.num_points;
    info[1] = m.num_faces;
    info[2] = (int64_t)m.attrs.size();
    return 0;
  });
}

// out[0]=unique_id, out[1]=att_type, out[2]=data_type, out[3]=components
int64_t tpu_pt_draco_attr_info(const uint8_t *buf, int64_t len, int64_t j,
                               int64_t *out) {
  return guarded([&]() -> int64_t {
    DecodedMesh m;
    if (!decode_stream(buf, len, m)) return -1;
    if (j < 0 || j >= (int64_t)m.attrs.size()) {
      set_error("draco: attribute index out of range");
      return -1;
    }
    out[0] = m.attrs[j].unique_id;
    out[1] = m.attrs[j].att_type;
    out[2] = m.attrs[j].data_type;
    out[3] = m.attrs[j].components;
    return 0;
  });
}

// out must hold 3*num_faces uint32
int64_t tpu_pt_draco_indices(const uint8_t *buf, int64_t len, uint32_t *out) {
  return guarded([&]() -> int64_t {
    DecodedMesh m;
    if (!decode_stream(buf, len, m)) return -1;
    std::memcpy(out, m.indices.data(), m.indices.size() * 4);
    return (int64_t)m.indices.size();
  });
}

// out must hold num_points*components float32 for attribute j
int64_t tpu_pt_draco_attr_f32(const uint8_t *buf, int64_t len, int64_t j,
                              float *out) {
  return guarded([&]() -> int64_t {
    DecodedMesh m;
    if (!decode_stream(buf, len, m)) return -1;
    if (j < 0 || j >= (int64_t)m.attrs.size()) {
      set_error("draco: attribute index out of range");
      return -1;
    }
    const Attribute &a = m.attrs[j];
    std::memcpy(out, a.values.data(), a.values.size() * 4);
    return (int64_t)a.values.size();
  });
}

// Encode pos (n,3) [+ optional nrm (n,3)] with faces idx (f,3).
// qpos/qnrm: quantization bits, 0 = raw float32.  Returns byte size written
// to out (capacity cap), or -1 (error) / required size if cap too small.
int64_t tpu_pt_draco_encode2(const float *pos, const float *nrm, int64_t n,
                             const uint32_t *idx, int64_t f, int64_t qpos,
                             int64_t qnrm, int64_t method, int64_t rans,
                             uint8_t *out, int64_t cap);

int64_t tpu_pt_draco_encode(const float *pos, const float *nrm, int64_t n,
                            const uint32_t *idx, int64_t f, int64_t qpos,
                            int64_t qnrm, uint8_t *out, int64_t cap) {
  return tpu_pt_draco_encode2(pos, nrm, n, idx, f, qpos, qnrm, 0, 0, out,
                              cap);
}

// method: 0 = sequential; 1 = edgebreaker where the topology allows it
// (closed 2-manifold genus-0 components, every vertex referenced),
// silently falling back to sequential otherwise — byte 8 of the output
// names the method actually used.  rans: 1 = rANS-code quantized values.
int64_t tpu_pt_draco_encode2(const float *pos, const float *nrm, int64_t n,
                             const uint32_t *idx, int64_t f, int64_t qpos,
                             int64_t qnrm, int64_t method, int64_t rans,
                             uint8_t *out, int64_t cap) {
  return guarded([&]() -> int64_t {
  if (n <= 0 || f <= 0 || n > 0x7fffffff || f > 0x7fffffff) {
    set_error("draco: bad point/face count");
    return -1;
  }
  if (qpos > 30 || qnrm > 30) {
    set_error("draco: quantization bits must be <= 30");
    return -1;
  }
  for (int64_t i = 0; i < 3 * f; ++i)
    if (idx[i] >= (uint64_t)n) {
      set_error("draco: face index out of range");
      return -1;
    }
  bool rans_values = rans != 0;

  EbEncoded eb;
  bool use_eb = false;
  std::string eb_why;
  std::vector<float> pos_eb, nrm_eb;
  if (method == 1) {
    use_eb = edgebreaker_encode_connectivity(n, idx, f, eb, &eb_why);
    if (use_eb) {
      // attribute values follow the DECODER's vertex numbering
      pos_eb.resize((size_t)n * 3);
      if (nrm) nrm_eb.resize((size_t)n * 3);
      for (int64_t i = 0; i < n; ++i) {
        int32_t o = eb.vperm[i];
        for (int c = 0; c < 3; ++c) {
          pos_eb[(size_t)i * 3 + c] = pos[(size_t)o * 3 + c];
          if (nrm) nrm_eb[(size_t)i * 3 + c] = nrm[(size_t)o * 3 + c];
        }
      }
      pos = pos_eb.data();
      if (nrm) nrm = nrm_eb.data();
    }
  }

  Writer w;
  const char magic[5] = {'D', 'R', 'A', 'C', 'O'};
  for (char c : magic) w.u8((uint8_t)c);
  w.u8(2);                // major
  w.u8(2);                // minor
  w.u8(1);                // TRIANGULAR_MESH
  w.u8(use_eb ? 1 : 0);   // encoding method
  w.u16(0);               // flags

  if (use_eb) {
    w.u8(0);  // standard traversal
    w.varu32((uint32_t)n);
    w.varu32((uint32_t)f);
    w.varu32((uint32_t)eb.comp_nsym.size());
    for (uint32_t s : eb.comp_nsym) w.varu32(s);
    w.varu32((uint32_t)eb.clers.size());
    w.out.insert(w.out.end(), eb.clers.begin(), eb.clers.end());
  } else {
    w.varu32((uint32_t)f);
    w.varu32((uint32_t)n);
    w.u8(1);  // uncompressed connectivity
    if (n < (1 << 8)) {
      for (int64_t i = 0; i < 3 * f; ++i) w.u8((uint8_t)idx[i]);
    } else if (n < (1 << 16)) {
      for (int64_t i = 0; i < 3 * f; ++i) w.u16((uint16_t)idx[i]);
    } else if (n < (1 << 21)) {
      for (int64_t i = 0; i < 3 * f; ++i) w.varu32(idx[i]);
    } else {
      for (int64_t i = 0; i < 3 * f; ++i) w.u32(idx[i]);
    }
  }

  uint8_t n_attrs = nrm ? 2 : 1;
  w.u8(1);  // one attributes decoder
  w.varu32(n_attrs);
  encode_attr_header(w, 0 /*POSITION*/, 3, 0);
  if (nrm) encode_attr_header(w, 1 /*NORMAL*/, 3, 1);
  w.u8(qpos > 0 ? SEQ_QUANTIZATION : SEQ_GENERIC);
  if (nrm) w.u8(qnrm > 0 ? SEQ_QUANTIZATION : SEQ_GENERIC);
  // portable values for all attributes, then transform data; our encoder
  // emits quantization transform data inline per attribute in spec order
  // (portable block j, ..., then transform block j, ...), matching the
  // decoder above: emit portable parts first.
  {
    // Split portable and transform parts to honor the ordering.
    Writer portable, xform;
    // positions
    if (qpos > 0) {
      Writer tmp;
      encode_attr_values(tmp, pos, (uint64_t)n, 3, (int)qpos, rans_values);
      // last 3*4 + 4 + 1 bytes are transform data
      size_t xlen = 3 * 4 + 4 + 1;
      portable.out.insert(portable.out.end(), tmp.out.begin(),
                          tmp.out.end() - xlen);
      xform.out.insert(xform.out.end(), tmp.out.end() - xlen, tmp.out.end());
    } else {
      encode_attr_values(portable, pos, (uint64_t)n, 3, 0);
    }
    if (nrm) {
      if (qnrm > 0) {
        Writer tmp;
        encode_attr_values(tmp, nrm, (uint64_t)n, 3, (int)qnrm, rans_values);
        size_t xlen = 3 * 4 + 4 + 1;
        portable.out.insert(portable.out.end(), tmp.out.begin(),
                            tmp.out.end() - xlen);
        xform.out.insert(xform.out.end(), tmp.out.end() - xlen, tmp.out.end());
      } else {
        encode_attr_values(portable, nrm, (uint64_t)n, 3, 0);
      }
    }
    w.out.insert(w.out.end(), portable.out.begin(), portable.out.end());
    w.out.insert(w.out.end(), xform.out.begin(), xform.out.end());
  }

  int64_t size = (int64_t)w.out.size();
  if (size > cap) return size;  // caller retries with a bigger buffer
  std::memcpy(out, w.out.data(), (size_t)size);
  return size;
  });
}

}  // extern "C"
