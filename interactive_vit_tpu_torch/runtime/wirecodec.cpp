// Native wire-codec hot path: single-pass block scan + single-alloc pack.
//
// The serving layer moves multi-MB binary tensor messages per request
// (reference protocol, the reference's main/message.py:22-127 — the 42-node
// VGG16 response carries ~42 tensor blocks). The Python codec is
// numpy-vectorized per block but still loops in the interpreter; this native
// path scans the whole block table in one pass (decode) and assembles the
// response with bare memcpys into one allocation (encode). Loaded via
// ctypes; interactive_vit_tpu_torch/wire/codec.py runs its Python tier
// only where IVT_NATIVE=0 asks for it.
//
// Build: python -m interactive_vit_tpu_torch.runtime.build  (g++ -O3 -shared)

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t kHeaderSize = 16;

inline uint64_t align4(uint64_t n) { return (n + 3) & ~uint64_t{3}; }

inline uint32_t read_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);  // little-endian hosts only (x86/ARM LE)
  return v;
}

inline void write_u32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }

}  // namespace

extern "C" {

// Scan a wire message. Outputs (per block i < max_blocks):
//   dims_off[i]  byte offset of the u32 dims array
//   dim_cnt[i]   number of dims
//   data_off[i]  byte offset of the f32 payload
//   elem_cnt[i]  number of f32 elements
// json_out[0] = json byte offset, json_out[1] = json size.
// Returns block count, or a negative error code:
//   -1 short header  -2 bad magic  -3 truncated  -4 block size mismatch
//   -5 too many blocks
int ivt_scan(const uint8_t* buf, uint64_t len, uint32_t expect_magic,
             uint64_t* json_out, uint64_t* dims_off, uint32_t* dim_cnt,
             uint64_t* data_off, uint64_t* elem_cnt, int max_blocks) {
  if (len < kHeaderSize) return -1;
  const uint32_t byte_size = read_u32(buf);
  const uint32_t magic = read_u32(buf + 4);
  const uint32_t block_cnt = read_u32(buf + 8);
  const uint32_t json_size = read_u32(buf + 12);
  if (magic != expect_magic) return -2;
  if (byte_size > len) return -3;
  if (kHeaderSize + json_size > len) return -3;  // json extent in range
  // UNSIGNED compare: casting block_cnt >= 2^31 to int yields a negative
  // value that would bypass the guard and let the scan loop write block
  // metadata past the caller's fixed arrays (heap corruption from
  // network input)
  if (max_blocks < 0 ||
      block_cnt > static_cast<uint32_t>(max_blocks)) return -5;

  json_out[0] = kHeaderSize;
  json_out[1] = json_size;

  uint64_t off = align4(kHeaderSize + json_size);
  for (uint32_t i = 0; i < block_cnt; ++i) {
    if (off + 8 > len) return -3;
    const uint64_t start = off;
    const uint32_t block_size = read_u32(buf + off);
    const uint32_t dims = read_u32(buf + off + 4);
    off += 8;
    // wrap-proof form: off <= len holds here (previous checks), so
    // len - off cannot underflow; "off + 4*dims > len" would wrap for
    // adversarial values and accept an out-of-range extent
    if (4ull * dims > len - off) return -3;
    dims_off[i] = off;
    dim_cnt[i] = dims;
    uint64_t elems = 1;
    for (uint32_t d = 0; d < dims; ++d) {
      const uint64_t dim = read_u32(buf + off + 4ull * d);
      // overflow guard: a crafted dims product wrapping 2^64 could pass
      // the extent check below with a forged block_size
      if (dim != 0 && elems > UINT64_MAX / 4 / dim) return -4;
      elems *= dim;
    }
    off += 4ull * dims;
    // elems <= UINT64_MAX/4 (guard above) so 4*elems cannot wrap, but
    // off + 4*elems CAN (verified: dims [0x80000002,0x7FFFFFFE] gives
    // 4*elems = 2^64-16, wrapping past len and leaking a raw numpy
    // ValueError where the contract requires WireError) — compare
    // against the remaining extent instead
    if (4ull * elems > len - off) return -3;
    data_off[i] = off;
    elem_cnt[i] = elems;
    off += 4ull * elems;
    if (start + block_size != off) return -4;
  }
  return static_cast<int>(block_cnt);
}

// Total bytes a message with this json size and these blocks will occupy.
uint64_t ivt_encoded_size(uint64_t json_size, const uint32_t* dim_cnt,
                          const uint64_t* elem_cnt, int blocks) {
  uint64_t size = align4(kHeaderSize + json_size);
  for (int i = 0; i < blocks; ++i) {
    size += 8 + 4ull * dim_cnt[i] + 4ull * elem_cnt[i];
  }
  return size;
}

// Pack a full message into `out` (caller allocates ivt_encoded_size bytes).
// dims[i] points at u32[dim_cnt[i]]; data[i] at f32[elem_cnt[i]].
// Returns bytes written.
// Returns bytes written, or 0 when the message (or any single block)
// exceeds the u32 wire size fields — the caller must fall back / error
// loudly instead of emitting silently wrapped framing (the Python
// encoder fails with struct.error in the same case).
uint64_t ivt_pack(uint8_t* out, uint32_t magic, const uint8_t* json,
                  uint64_t json_size, const uint8_t* const* dims,
                  const uint32_t* dim_cnt, const uint8_t* const* data,
                  const uint64_t* elem_cnt, int blocks) {
  const uint64_t total =
      ivt_encoded_size(json_size, dim_cnt, elem_cnt, blocks);
  if (total > UINT32_MAX || json_size > UINT32_MAX) return 0;
  for (int i = 0; i < blocks; ++i) {
    if (8 + 4ull * dim_cnt[i] + 4ull * elem_cnt[i] > UINT32_MAX) return 0;
  }
  write_u32(out, static_cast<uint32_t>(total));
  write_u32(out + 4, magic);
  write_u32(out + 8, static_cast<uint32_t>(blocks));
  write_u32(out + 12, static_cast<uint32_t>(json_size));
  std::memcpy(out + kHeaderSize, json, json_size);
  uint64_t off = kHeaderSize + json_size;
  const uint64_t aligned = align4(off);
  std::memset(out + off, 0, aligned - off);
  off = aligned;
  for (int i = 0; i < blocks; ++i) {
    const uint64_t block_size = 8 + 4ull * dim_cnt[i] + 4ull * elem_cnt[i];
    write_u32(out + off, static_cast<uint32_t>(block_size));
    write_u32(out + off + 4, dim_cnt[i]);
    off += 8;
    std::memcpy(out + off, dims[i], 4ull * dim_cnt[i]);
    off += 4ull * dim_cnt[i];
    std::memcpy(out + off, data[i], 4ull * elem_cnt[i]);
    off += 4ull * elem_cnt[i];
  }
  return off;
}

}  // extern "C"
