// Native VTS inline-binary codec: zlib + base64 in one pass.
//
// The reference reads/writes .vts through pyvista, i.e. the VTK C++ library.
// This is the equivalent native tier for our framework's data loader: the
// XML payload blocks (base64 of [u32 header][zlib blocks]) are produced and
// consumed here without Python-level buffer shuffling, which matters for the
// multi-MB field arrays of large-N solutions and for sweep post-processing
// that loads dozens of stored .vts truths.
//
// The port's own copy of the JAX package's codec, built and bound by
// anap3_tpu_torch/utils/native.py. Host file I/O: no kernel of the card.
// One change: a last-block size of 0 in the header means a full last
// block (VTK writes it so when the payload fills its blocks, as in the
// stored truths' field arrays); the JAX copy refuses such a payload and
// its caller decodes it in Python.
//
// C ABI (loaded via ctypes from anap3_tpu_torch/utils/native.py):
//   vts_encode(src, n, level, dst, dst_cap) -> bytes written or -needed
//   vts_decode(b64, b64_len, dst, dst_cap)  -> bytes written or -needed
//   vts_decoded_size(b64, b64_len)          -> decompressed payload size
//
// Build: g++ -O3 -shared -fPIC -o libvtscodec.so vts_codec.cpp -lz

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

const char B64_TAB[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

int8_t b64_inv(char c) {
  if (c >= 'A' && c <= 'Z') return c - 'A';
  if (c >= 'a' && c <= 'z') return c - 'a' + 26;
  if (c >= '0' && c <= '9') return c - '0' + 52;
  if (c == '+') return 62;
  if (c == '/') return 63;
  return -1;  // padding or whitespace
}

size_t b64_encode(const uint8_t* src, size_t n, char* dst) {
  size_t o = 0;
  size_t i = 0;
  for (; i + 2 < n; i += 3) {
    uint32_t v = (src[i] << 16) | (src[i + 1] << 8) | src[i + 2];
    dst[o++] = B64_TAB[(v >> 18) & 63];
    dst[o++] = B64_TAB[(v >> 12) & 63];
    dst[o++] = B64_TAB[(v >> 6) & 63];
    dst[o++] = B64_TAB[v & 63];
  }
  if (i < n) {
    uint32_t v = src[i] << 16;
    if (i + 1 < n) v |= src[i + 1] << 8;
    dst[o++] = B64_TAB[(v >> 18) & 63];
    dst[o++] = B64_TAB[(v >> 12) & 63];
    dst[o++] = (i + 1 < n) ? B64_TAB[(v >> 6) & 63] : '=';
    dst[o++] = '=';
  }
  return o;
}

// Decode skipping whitespace; returns bytes written.
size_t b64_decode(const char* src, size_t n, uint8_t* dst) {
  uint32_t acc = 0;
  int bits = 0;
  size_t o = 0;
  for (size_t i = 0; i < n; ++i) {
    int8_t v = b64_inv(src[i]);
    if (v < 0) continue;
    acc = (acc << 6) | static_cast<uint32_t>(v);
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      dst[o++] = static_cast<uint8_t>((acc >> bits) & 0xff);
    }
  }
  return o;
}

}  // namespace

extern "C" {

// Encode raw bytes as VTK inline-binary: base64(u32 header x4) + base64(zlib).
// Returns the number of characters written to dst, or -(required capacity)
// if dst_cap is insufficient.
long long vts_encode(const uint8_t* src, long long n, int level, char* dst,
                     long long dst_cap) {
  uLongf comp_cap = compressBound(static_cast<uLong>(n));
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, src, static_cast<uLong>(n), level) !=
      Z_OK) {
    return -1;
  }
  uint32_t header[4] = {1, static_cast<uint32_t>(n), static_cast<uint32_t>(n),
                        static_cast<uint32_t>(comp_cap)};
  long long need =
      static_cast<long long>(4 * ((sizeof(header) + 2) / 3)) +
      static_cast<long long>(4 * ((comp_cap + 2) / 3));
  if (dst_cap < need) return -need;
  size_t o = b64_encode(reinterpret_cast<const uint8_t*>(header),
                        sizeof(header), dst);
  o += b64_encode(comp.data(), comp_cap, dst + o);
  return static_cast<long long>(o);
}

// Total decompressed size of an inline-binary payload (compressed form).
long long vts_decoded_size(const char* b64, long long b64_len) {
  // decode just the first 3 header words (4 b64 chars -> 3 bytes)
  uint8_t head[16];
  size_t got = b64_decode(b64, b64_len < 24 ? b64_len : 24, head);
  if (got < 12) return -1;
  uint32_t n_blocks, block_size, last_size;
  std::memcpy(&n_blocks, head, 4);
  std::memcpy(&block_size, head + 4, 4);
  std::memcpy(&last_size, head + 8, 4);
  if (n_blocks == 0) return 0;
  if (last_size == 0) last_size = block_size;  // VTK: the last block is full
  return static_cast<long long>(n_blocks - 1) * block_size + last_size;
}

// Decode a zlib-compressed inline-binary payload into dst.
// Returns bytes written, or -(required capacity), or -1 on corrupt data.
long long vts_decode(const char* b64, long long b64_len, uint8_t* dst,
                     long long dst_cap) {
  std::vector<uint8_t> raw(3 * (static_cast<size_t>(b64_len) / 4) + 4);
  size_t raw_n = b64_decode(b64, b64_len, raw.data());
  if (raw_n < 12) return -1;
  uint32_t n_blocks;
  std::memcpy(&n_blocks, raw.data(), 4);
  size_t header_bytes = (3 + n_blocks) * 4;
  // The header and payload are base64-encoded SEPARATELY and concatenated;
  // re-decode from the payload boundary to stay aligned.
  size_t header_b64 = 4 * ((header_bytes + 2) / 3);
  if (static_cast<size_t>(b64_len) < header_b64) return -1;
  std::vector<uint8_t> header(header_bytes + 3);
  b64_decode(b64, header_b64, header.data());
  std::vector<uint32_t> csizes(n_blocks);
  std::memcpy(csizes.data(), header.data() + 12, n_blocks * 4);

  std::vector<uint8_t> payload(3 * ((b64_len - header_b64) / 4) + 4);
  size_t payload_n =
      b64_decode(b64 + header_b64, b64_len - header_b64, payload.data());

  uint32_t block_size, last_size;
  std::memcpy(&block_size, header.data() + 4, 4);
  std::memcpy(&last_size, header.data() + 8, 4);
  if (last_size == 0) last_size = block_size;  // VTK: the last block is full
  long long total = (n_blocks == 0)
                        ? 0
                        : static_cast<long long>(n_blocks - 1) * block_size +
                              last_size;
  if (dst_cap < total) return -total;

  size_t in_off = 0;
  long long out_off = 0;
  for (uint32_t b = 0; b < n_blocks; ++b) {
    if (in_off + csizes[b] > payload_n) return -1;
    uLongf out_len = (b + 1 == n_blocks) ? last_size : block_size;
    if (uncompress(dst + out_off, &out_len, payload.data() + in_off,
                   csizes[b]) != Z_OK) {
      return -1;
    }
    in_off += csizes[b];
    out_off += out_len;
  }
  return out_off;
}

}  // extern "C"
