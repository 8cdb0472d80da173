// Native codec core for the reference binary serialization format.
//
// The reference's Serialization.cpp (C++/NTL) streams ZZ records as
//   u32 nbytes | u8 neg | nbytes little-endian magnitude
// This core scans/emits runs of such records at memcpy speed; the Python
// layer (refserial.py) owns the object framing and falls back to pure
// Python when this library is not built or a record exceeds the stride.
//
// Build: fhe_si_tpu_torch/native/__init__.py compiles it at first use
// (g++ -O2 -shared -fPIC) into fhe_si_tpu_torch/_build/.

#include <cstdint>
#include <cstring>

extern "C" {

// Scan n consecutive ZZ records starting at buf+off.
// Magnitudes are written little-endian into out + i*stride (zero padded);
// sign flags into signs[i].  Returns the offset one past the last record,
// or -1 on truncation, or -2 if any record's nbytes exceeds stride.
long long fsi_scan_zz_array(const unsigned char *buf, long long buflen,
                            long long off, long long n, long long stride,
                            unsigned char *out, signed char *signs) {
  for (long long i = 0; i < n; i++) {
    if (off + 5 > buflen) return -1;
    uint32_t nbytes;
    std::memcpy(&nbytes, buf + off, 4);
    signs[i] = buf[off + 4] ? 1 : 0;
    off += 5;
    if (off + (long long)nbytes > buflen) return -1;
    if ((long long)nbytes > stride) return -2;
    unsigned char *dst = out + i * stride;
    std::memcpy(dst, buf + off, nbytes);
    if ((long long)nbytes < stride)
      std::memset(dst + nbytes, 0, stride - nbytes);
    off += nbytes;
  }
  return off;
}

// Emit n ZZ records from little-endian magnitudes at in + i*stride with
// sign flags; trailing zero bytes trimmed (NumBytes semantics).  out must
// hold at least n*(5+stride) bytes.  Returns bytes written.
long long fsi_emit_zz_array(const unsigned char *in, long long n,
                            long long stride, const signed char *signs,
                            unsigned char *out) {
  long long w = 0;
  for (long long i = 0; i < n; i++) {
    const unsigned char *src = in + i * stride;
    long long nbytes = stride;
    while (nbytes > 0 && src[nbytes - 1] == 0) nbytes--;
    uint32_t nb32 = (uint32_t)nbytes;
    std::memcpy(out + w, &nb32, 4);
    out[w + 4] = signs[i] ? 1 : 0;
    w += 5;
    std::memcpy(out + w, src, nbytes);
    w += nbytes;
  }
  return w;
}

}  // extern "C"
