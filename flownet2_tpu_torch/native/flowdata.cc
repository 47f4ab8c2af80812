// flowdata: native decode/encode for the host data path.
//
// The reference framework's data path is C++ end to end (LMDB datum decode in
// src/caffe/layers/custom_data_layer.cpp:86-132, dataset packing in
// tools/convert_imageset_and_flow.cpp). This library is its counterpart in
// the PyTorch package: netpbm parsing, Middlebury .flo framing, the int16
// fixed-point flow codec, occlusion bit unpacking and whole packed-record
// decode, behind a plain C ABI that flownet2_tpu_torch/data/native.py binds
// with ctypes. The ABI is the one of the JAX package's cpp/flowdata.cc. The
// numpy versions in flownet2_tpu_torch/core/codec.py and core/flow_io.py are
// the plain versions the tests hold it against.
//
// Built with g++ -O3 on first use (data/native.py::build).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Fixed-point flow codec (the reference's datum encoding): int16 =
// round(flow * 32), half to even, saturated to [-32768, 32766]; a value whose
// scaled form is not finite (NaN, inf, or beyond float's range once scaled)
// -> 32767 (SHRT_MAX). Decode divides by 32 and maps the sentinel to NaN.
// ---------------------------------------------------------------------------

static const int16_t kNanSentinel = 32767;
static const float kFlowScale = 32.0f;
static const uint32_t kQuietNanBits = 0x7fc00000u;  // numpy's float32 NaN

// Decode n int16 values read from `in`, which need not be 2-byte aligned.
// The NaN is blended in with a bit mask rather than a branch, so that the
// compiler vectorizes the loop.
static void decode_flow(const uint8_t* in, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    int16_t v;
    std::memcpy(&v, in + 2 * i, 2);
    float f = static_cast<float>(v) * (1.0f / kFlowScale);  // a power of two: exact, as / 32
    uint32_t bits;
    std::memcpy(&bits, &f, 4);
    uint32_t nan_mask = 0u - static_cast<uint32_t>(v == kNanSentinel);
    bits = (bits & ~nan_mask) | (kQuietNanBits & nan_mask);
    std::memcpy(out + i, &bits, 4);
  }
}

void fd_decode_flow_i16(const int16_t* in, float* out, int64_t n) {
  decode_flow(reinterpret_cast<const uint8_t*>(in), out, n);
}

void fd_encode_flow_i16(const float* in, int16_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float s = std::nearbyint(in[i] * kFlowScale);
    if (!std::isfinite(s)) {
      out[i] = kNanSentinel;
      continue;
    }
    if (s < -32768.0f) s = -32768.0f;
    if (s > 32766.0f) s = 32766.0f;
    out[i] = static_cast<int16_t>(s);
  }
}

// ---------------------------------------------------------------------------
// Occlusion bit packing: 1 bit per pixel, little-endian bit order within each
// byte (bit i % 8 of byte i / 8 is pixel i).
// ---------------------------------------------------------------------------

void fd_unpack_bits(const uint8_t* in, float* out, int64_t n) {
  for (int64_t j = 0; j < n / 8; ++j) {  // whole bytes, in a form the compiler vectorizes
    uint8_t b = in[j];
    for (int k = 0; k < 8; ++k) out[8 * j + k] = static_cast<float>((b >> k) & 1);
  }
  for (int64_t i = n / 8 * 8; i < n; ++i) {
    out[i] = static_cast<float>((in[i >> 3] >> (i & 7)) & 1);
  }
}

void fd_pack_bits(const uint8_t* in, uint8_t* out, int64_t n) {
  std::memset(out, 0, static_cast<size_t>((n + 7) / 8));
  for (int64_t i = 0; i < n; ++i) {
    if (in[i]) out[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
  }
}

// ---------------------------------------------------------------------------
// netpbm (P5/P6, maxval <= 255). Returns 0 on success; fills w/h/channels and
// writes the pixel bytes to `out` if out_capacity suffices. Call with
// out = null to query the dimensions. -1 bad magic or header token, -2 not
// P5/P6, -3 missing header field, -4 maxval > 255 or a zero size, -5
// truncated payload or capacity.
// ---------------------------------------------------------------------------

static const long kPnmMaxDim = 1L << 24;  // more digits than any image needs

static int pnm_token(const uint8_t* buf, int64_t len, int64_t* pos, long* value) {
  // skip whitespace and '#' comments
  while (*pos < len) {
    uint8_t c = buf[*pos];
    if (c == '#') {
      while (*pos < len && buf[*pos] != '\n') ++(*pos);
    } else if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
      ++(*pos);
    } else {
      break;
    }
  }
  if (*pos >= len) return -1;
  long v = 0;
  int digits = 0;
  while (*pos < len && buf[*pos] >= '0' && buf[*pos] <= '9') {
    v = v * 10 + (buf[*pos] - '0');
    if (v > kPnmMaxDim) return -1;
    ++(*pos);
    ++digits;
  }
  if (!digits) return -1;
  *value = v;
  return 0;
}

int fd_decode_pnm(const uint8_t* buf, int64_t len, uint8_t* out,
                  int64_t out_capacity, int32_t* width, int32_t* height,
                  int32_t* channels) {
  if (len < 2 || buf[0] != 'P') return -1;
  int ch;
  if (buf[1] == '6') ch = 3;
  else if (buf[1] == '5') ch = 1;
  else return -2;
  int64_t pos = 2;
  long w, h, maxval;
  if (pnm_token(buf, len, &pos, &w) || pnm_token(buf, len, &pos, &h) ||
      pnm_token(buf, len, &pos, &maxval))
    return -3;
  if (maxval > 255 || w <= 0 || h <= 0) return -4;
  ++pos;  // single whitespace after maxval
  int64_t need = static_cast<int64_t>(w) * h * ch;
  *width = static_cast<int32_t>(w);
  *height = static_cast<int32_t>(h);
  *channels = ch;
  if (!out) return 0;
  if (len - pos < need || out_capacity < need) return -5;
  std::memcpy(out, buf + pos, static_cast<size_t>(need));
  return 0;
}

// ---------------------------------------------------------------------------
// Middlebury .flo ("PIEH" float magic, int32 w, int32 h, interleaved u, v).
// -1 bad magic or short header, -2 a size <= 0, -3 truncated or capacity.
// ---------------------------------------------------------------------------

int fd_read_flo(const uint8_t* buf, int64_t len, float* out,
                int64_t out_capacity, int32_t* width, int32_t* height) {
  if (len < 12 || std::memcmp(buf, "PIEH", 4) != 0) return -1;
  int32_t w, h;
  std::memcpy(&w, buf + 4, 4);
  std::memcpy(&h, buf + 8, 4);
  if (w <= 0 || h <= 0) return -2;
  int64_t need = static_cast<int64_t>(w) * h * 2;
  *width = w;
  *height = h;
  if (!out) return 0;
  if (len - 12 < need * 4 || out_capacity < need) return -3;
  std::memcpy(out, buf + 12, static_cast<size_t>(need) * 4);
  return 0;
}

int fd_write_flo_header(uint8_t* out, int32_t width, int32_t height) {
  std::memcpy(out, "PIEH", 4);
  std::memcpy(out + 4, &width, 4);
  std::memcpy(out + 8, &height, 4);
  return 12;
}

// ---------------------------------------------------------------------------
// Packed flow record decode (the .flowrec body; data/records.py): header
// H, W, flags (u32 LE each), then img0 u8[H*W*3], img1 u8[H*W*3], flow
// i16[H*W*C] (C = 1 with flag bit 1, disparity, else 2) and, with flag bit 0,
// the occlusion bits. Writes float32 planes: images 0..255, flow decoded,
// occlusion 0/1. Returns 0 on success; -1 short header or a size above
// INT32_MAX, -2 truncated. Call with img0 = null to query the sizes.
// ---------------------------------------------------------------------------

int fd_decode_record(const uint8_t* body, int64_t len, float* img0,
                     float* img1, float* flow, float* occ,
                     int32_t* width, int32_t* height, int32_t* has_occ,
                     int32_t* flow_channels) {
  if (len < 12) return -1;
  uint32_t h, w, flags;
  std::memcpy(&h, body, 4);
  std::memcpy(&w, body + 4, 4);
  std::memcpy(&flags, body + 8, 4);
  if (h > static_cast<uint32_t>(INT32_MAX) || w > static_cast<uint32_t>(INT32_MAX)) return -1;
  // every pixel takes at least 8 bytes: a larger count cannot fit in `len`,
  // and bounding it first keeps the byte count below from overflowing
  uint64_t px_u = static_cast<uint64_t>(h) * w;
  if (px_u > static_cast<uint64_t>(len)) return -2;
  int64_t px = static_cast<int64_t>(px_u);
  int occ_present = flags & 1;
  int64_t n_flow = (flags & 2) ? 1 : 2;
  int64_t need = 12 + px * 3 * 2 + px * n_flow * 2;
  if (occ_present) need += (px + 7) / 8;
  if (len < need) return -2;
  *width = static_cast<int32_t>(w);
  *height = static_cast<int32_t>(h);
  *has_occ = occ_present;
  *flow_channels = static_cast<int32_t>(n_flow);
  if (!img0) return 0;

  const uint8_t* p = body + 12;
  for (int64_t i = 0; i < px * 3; ++i) img0[i] = static_cast<float>(p[i]);
  p += px * 3;
  for (int64_t i = 0; i < px * 3; ++i) img1[i] = static_cast<float>(p[i]);
  p += px * 3;
  decode_flow(p, flow, px * n_flow);  // the body need not be 2-byte aligned
  p += px * n_flow * 2;
  if (occ_present && occ) fd_unpack_bits(p, occ, px);
  return 0;
}

int fd_version() { return 2; }

}  // extern "C"
