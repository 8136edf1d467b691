// Bitshuffle + LZ4 HDF5 filter plugin (filter id 32008), from scratch.
//
// Host codec (not a device kernel).  driftscan stores beam-transfer
// products with the bitshuffle+LZ4 codec: mantissa-truncated floats bit-transpose into long runs of
// zero bits, which LZ4 then collapses — far better ratios than byte-wise
// shuffle + LZF at similar speed.
//
// This implementation follows the publicly documented bitshuffle stream
// format (kiyo-masui/bitshuffle README: 8-byte big-endian total
// uncompressed size, 4-byte big-endian block size in bytes, then per
// block a 4-byte big-endian compressed length + LZ4 block), written
// independently in portable C++.  The bit transpose is the plain
// definition: within each block of N elements x B bytes, output bit
// (j*N + e) = bit j of element e, LSB-first within bytes.
//
// Deliberately self-contained: the filter takes elem/block sizes from
// cd_values supplied by the writer (no H5T/H5P calls), so the plugin
// has no HDF5 link dependency — only the two plugin-info entry points,
// whose tiny stable ABI structs are declared below.  LZ4 is used via
// its stable public ABI (liblz4.so.1).
//
// Built at first use by driftscan_tpu_torch/ops/bitshuffle.py with the host
// C++ compiler (backend.build_host); loaded through H5PLappend.

#include <cstdint>
#include <cstdlib>
#include <cstring>

// ---- LZ4 public ABI (stable since 1.7; provided by liblz4.so.1) ----
extern "C" {
int LZ4_compress_default(const char *src, char *dst, int srcSize, int dstCap);
int LZ4_decompress_safe(const char *src, char *dst, int cmpSize, int dstCap);
int LZ4_compressBound(int inputSize);
}

// ---- minimal stable HDF5 filter-plugin ABI declarations ----
extern "C" {
typedef int herr_t;
typedef int H5Z_filter_t;

typedef size_t (*H5Z_func_t)(unsigned flags, size_t cd_nelmts,
                             const unsigned cd_values[], size_t nbytes,
                             size_t *buf_size, void **buf);

typedef struct H5Z_class2_t {
  int version;               // H5Z_CLASS_T_VERS == 1
  H5Z_filter_t id;
  unsigned encoder_present;
  unsigned decoder_present;
  const char *name;
  void *can_apply;           // H5Z_can_apply_func_t (unused: NULL)
  void *set_local;           // H5Z_set_local_func_t (unused: NULL)
  H5Z_func_t filter;
} H5Z_class2_t;

typedef enum { H5PL_TYPE_ERROR = -1, H5PL_TYPE_FILTER = 0 } H5PL_type_t;
}

static const unsigned H5Z_FLAG_REVERSE = 0x0100u;
static const int BSHUF_H5FILTER = 32008;
static const unsigned BSHUF_H5_COMPRESS_LZ4 = 2;

// ------------------------------------------------------------------
// bit transpose
// ------------------------------------------------------------------

// Transpose a block of n elements (multiple of 8) of elem_size bytes:
// out bit (j*n + e) = bit j of element e (j = byte*8 + bit, LSB first).
static void bitshuffle_block(const uint8_t *in, uint8_t *out, size_t n,
                             size_t elem) {
  const size_t nbits = elem * 8;
  std::memset(out, 0, n * elem);
  // Byte-transpose first (cache-friendly), then transpose bits within
  // each byte-row: row j8 holds byte j8 of every element; its bit k goes
  // to output row j8*8 + k.
  for (size_t j8 = 0; j8 < elem; j8++) {
    uint8_t *rows[8];
    for (int k = 0; k < 8; k++)
      rows[k] = out + ((j8 * 8 + k) * n) / 8;
    for (size_t e = 0; e < n; e += 8) {
      // gather 8 elements' byte j8
      uint8_t b[8];
      for (int t = 0; t < 8; t++)
        b[t] = in[(e + t) * elem + j8];
      for (int k = 0; k < 8; k++) {
        uint8_t packed = 0;
        for (int t = 0; t < 8; t++)
          packed |= (uint8_t)(((b[t] >> k) & 1u) << t);
        rows[k][e / 8] = packed;
      }
    }
  }
  (void)nbits;
}

static void bitunshuffle_block(const uint8_t *in, uint8_t *out, size_t n,
                               size_t elem) {
  std::memset(out, 0, n * elem);
  for (size_t j8 = 0; j8 < elem; j8++) {
    const uint8_t *rows[8];
    for (int k = 0; k < 8; k++)
      rows[k] = in + ((j8 * 8 + k) * n) / 8;
    for (size_t e = 0; e < n; e += 8) {
      for (int k = 0; k < 8; k++) {
        uint8_t packed = rows[k][e / 8];
        for (int t = 0; t < 8; t++)
          out[(e + t) * elem + j8] |=
              (uint8_t)(((packed >> t) & 1u) << k);
      }
    }
  }
}

// ------------------------------------------------------------------
// big-endian helpers
// ------------------------------------------------------------------

static void put_be64(uint8_t *p, uint64_t v) {
  for (int i = 0; i < 8; i++) p[i] = (uint8_t)(v >> (56 - 8 * i));
}
static void put_be32(uint8_t *p, uint32_t v) {
  for (int i = 0; i < 4; i++) p[i] = (uint8_t)(v >> (24 - 8 * i));
}
static uint64_t get_be64(const uint8_t *p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
  return v;
}
static uint32_t get_be32(const uint8_t *p) {
  uint32_t v = 0;
  for (int i = 0; i < 4; i++) v = (v << 8) | p[i];
  return v;
}

// ------------------------------------------------------------------
// the filter
// ------------------------------------------------------------------

static size_t bshuf_lz4_filter(unsigned flags, size_t cd_nelmts,
                               const unsigned cd_values[], size_t nbytes,
                               size_t *buf_size, void **buf) {
  // cd_values: [major, minor, elem_size, block_size_elems, compressor]
  size_t elem = cd_nelmts > 2 ? cd_values[2] : 0;
  size_t block = cd_nelmts > 3 && cd_values[3] ? cd_values[3] : 4096;
  unsigned comp = cd_nelmts > 4 ? cd_values[4] : BSHUF_H5_COMPRESS_LZ4;
  if (elem == 0 || comp != BSHUF_H5_COMPRESS_LZ4) return 0;
  block -= block % 8;  // blocks must hold a multiple of 8 elements
  if (block < 8) block = 8;

  const uint8_t *in = (const uint8_t *)*buf;

  if (flags & H5Z_FLAG_REVERSE) {
    // ---- decompress ----
    if (nbytes < 12) return 0;
    uint64_t total = get_be64(in);
    uint64_t bsize_bytes = get_be32(in + 8);
    if (bsize_bytes % elem) return 0;
    size_t belems = bsize_bytes / elem;
    size_t n = total / elem;

    uint8_t *out = (uint8_t *)std::malloc(total);
    uint8_t *tmp = (uint8_t *)std::malloc(bsize_bytes);
    if (!out || !tmp) { std::free(out); std::free(tmp); return 0; }

    size_t pos = 12, done = 0;
    size_t n_full = n - (n % 8);
    while (done < n_full) {
      size_t be = belems < (n_full - done) ? belems : (n_full - done);
      size_t bb = be * elem;
      if (pos + 4 > nbytes) goto fail_dec;
      {
        uint32_t clen = get_be32(in + pos);
        pos += 4;
        if (pos + clen > nbytes) goto fail_dec;
        int r = LZ4_decompress_safe((const char *)(in + pos), (char *)tmp,
                                    (int)clen, (int)bb);
        if (r != (int)bb) goto fail_dec;
        pos += clen;
      }
      bitunshuffle_block(tmp, out + done * elem, be, elem);
      done += be;
    }
    // trailing (< 8) elements stored raw
    if (n > n_full) {
      size_t rb = (n - n_full) * elem;
      if (pos + rb > nbytes) goto fail_dec;
      std::memcpy(out + n_full * elem, in + pos, rb);
    }
    std::free(tmp);
    std::free(*buf);
    *buf = out;
    *buf_size = total;
    return (size_t)total;
  fail_dec:
    std::free(out);
    std::free(tmp);
    return 0;
  }

  // ---- compress ----
  {
    size_t n = nbytes / elem;
    if (n * elem != nbytes) return 0;
    size_t n_full = n - (n % 8);
    size_t bb_max = block * elem;
    size_t nblocks = block ? (n_full + block - 1) / block : 0;
    size_t cap = 12 + nblocks * (4 + (size_t)LZ4_compressBound((int)bb_max)) +
                 (n - n_full) * elem + 64;

    uint8_t *out = (uint8_t *)std::malloc(cap);
    uint8_t *tmp = (uint8_t *)std::malloc(bb_max);
    if (!out || !tmp) { std::free(out); std::free(tmp); return 0; }

    put_be64(out, (uint64_t)nbytes);
    put_be32(out + 8, (uint32_t)(block * elem));
    size_t pos = 12, done = 0;
    while (done < n_full) {
      size_t be = block < (n_full - done) ? block : (n_full - done);
      be -= be % 8;
      size_t bb = be * elem;
      bitshuffle_block(in + done * elem, tmp, be, elem);
      int clen = LZ4_compress_default((const char *)tmp,
                                      (char *)(out + pos + 4), (int)bb,
                                      (int)(cap - pos - 4));
      if (clen <= 0) { std::free(out); std::free(tmp); return 0; }
      put_be32(out + pos, (uint32_t)clen);
      pos += 4 + (size_t)clen;
      done += be;
    }
    if (n > n_full) {
      std::memcpy(out + pos, in + n_full * elem, (n - n_full) * elem);
      pos += (n - n_full) * elem;
    }
    std::free(tmp);
    std::free(*buf);
    *buf = out;
    *buf_size = cap;
    return pos;
  }
}

static const H5Z_class2_t BSHUF_CLASS = {
    1,                 // H5Z_CLASS_T_VERS
    BSHUF_H5FILTER,    // id 32008
    1, 1,              // encoder, decoder present
    "bitshuffle; driftscan_tpu native implementation",
    nullptr, nullptr,  // can_apply / set_local: writer supplies cd_values
    bshuf_lz4_filter,
};

extern "C" {
H5PL_type_t H5PLget_plugin_type(void) { return H5PL_TYPE_FILTER; }
const void *H5PLget_plugin_info(void) { return (const void *)&BSHUF_CLASS; }
}
