// LAMMPS dump frames formatted in host C++: the bytes of
// mdtpu_torch/io/lammps.py:format_lammps_frame without Python's per-value
// string formatting.
//
// The port's own copy of the fixed-6 formatter and the frame layout of the
// JAX package's native writer (native/trajwriter.cc:40-230: fmt_ll, fmt_f6,
// the frame), without its zstd stream and thread: compression stays in
// io/compress.py (libzstd by ctypes; the card's machine has the library but
// not zstd.h), and the writer thread in io/writer.py calls this through
// ctypes, which releases the GIL for the call.
//
// Built with g++ -O2 -ffp-contract=off (mdtpu_torch/ops/_cuda_build.py):
// the unwrapped coordinates p + sum_j cell[k][j] image[j] round each product
// and sum as numpy does in the Python formatter, in the same order.
//
// Values of any size. The reference's fmt_f6 advances its row pointer by
// snprintf's untruncated return value into a fixed 512-byte row (ROADMAP
// C3): a value of magnitude 1e57 or more overruns it. Here a value is
// printed into a buffer of kMaxValue bytes, which holds the longest "%.6f"
// of any double (309 integer digits, the sign, the point and 6 decimals),
// and a row into kMaxRow bytes, which holds 7 of them and an id; the frame
// goes into the caller's buffer only as far as it has room. Infinities and
// NaN are printed as Python prints them ("inf", "-inf", "nan": glibc would
// print "-nan" for a NaN with its sign bit set).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int kMaxValue = 320;
constexpr int kMaxRow = 24 + 7 * (kMaxValue + 1) + 2;

char* fmt_ll(char* p, long long x) {
  unsigned long long u = x < 0 ? 0ull - static_cast<unsigned long long>(x)
                               : static_cast<unsigned long long>(x);
  if (x < 0) *p++ = '-';
  char tmp[24];
  int k = 0;
  do {
    tmp[k++] = static_cast<char>('0' + (u % 10));
    u /= 10;
  } while (u);
  while (k) *p++ = tmp[--k];
  return p;
}

// The correctly rounded "%.6f" of v, as Python's f"{v:.6f}" prints it.
//
// printf's %.6f rounds the exact decimal expansion of the double to 6
// places; exact ties cannot occur (a tie needs v = (2k+1)/2e6, whose
// reduced denominator holds 5^6, never a power of two). The computed
// product |v| * 1e6 carries at most 2^-53 relative error, so below 4e12
// its absolute error is below 1e-3: outside a band of +-1e-3 around the
// .5 boundary it rounds to the same integer as the exact value, and the
// digits are emitted directly. Inside the band and from 4e12 up, snprintf
// (correctly rounded) prints it, into a buffer that holds any double.
char* fmt_f6(char* p, double v) {
  if (std::isnan(v)) {
    std::memcpy(p, "nan", 3);
    return p + 3;
  }
  if (std::isinf(v)) {
    if (v < 0) *p++ = '-';
    std::memcpy(p, "inf", 3);
    return p + 3;
  }
  const double a = std::fabs(v);
  const double scaled = a * 1e6;
  const double fl = std::floor(scaled);
  const double frac = scaled - fl;
  if (!(scaled < 4.0e12) || std::fabs(frac - 0.5) < 1e-3) {
    char buf[kMaxValue];
    int len = std::snprintf(buf, sizeof(buf), "%.6f", v);
    if (len < 0) len = 0;
    if (len > kMaxValue - 1) len = kMaxValue - 1;
    std::memcpy(p, buf, static_cast<size_t>(len));
    return p + len;
  }
  if (std::signbit(v)) *p++ = '-';  // -0.000000 too, as printf and Python
  const long long i = static_cast<long long>(fl) + (frac > 0.5 ? 1 : 0);
  p = fmt_ll(p, i / 1000000);
  *p++ = '.';
  long long fp = i % 1000000;
  for (int d = 5; d >= 0; --d) {
    p[d] = static_cast<char>('0' + (fp % 10));
    fp /= 10;
  }
  return p + 6;
}

// Appends to the caller's buffer as far as it has room; counts every byte.
struct Out {
  char* buf;
  long long cap;
  long long len = 0;

  void put(const char* s, long long n) {
    if (len + n <= cap) std::memcpy(buf + len, s, static_cast<size_t>(n));
    len += n;
  }
  void put(const char* s) { put(s, static_cast<long long>(std::strlen(s))); }
};

// One line of box bounds: "lo hi tilt\n", the tilt a value or the literal
// "0.0" (tilt == nullptr).
void bounds_line(Out& out, double lo, double hi, const double* tilt) {
  char row[kMaxRow];
  char* q = fmt_f6(row, lo);
  *q++ = ' ';
  q = fmt_f6(q, hi);
  *q++ = ' ';
  if (tilt) {
    q = fmt_f6(q, *tilt);
  } else {
    std::memcpy(q, "0.0", 3);
    q += 3;
  }
  *q++ = '\n';
  out.put(row, q - row);
}

}  // namespace

extern "C" {

// Formats one frame: step, n atoms in dim (2 or 3) dimensions, cell (dim,
// dim) row-major (its columns are the box vectors), positions (n, dim),
// images (n, dim), diameters (n,). Writes the frame into out when it fits
// in cap bytes and returns its length in bytes either way (a caller whose
// buffer was short calls again with one that long); -1 for a dim other
// than 2 or 3.
long long mdtpu_lammps_format(long long step, long long n, int dim,
                              const double* cell, const double* positions,
                              const int32_t* images, const double* diameters,
                              char* out_buf, long long cap) {
  if (dim != 2 && dim != 3) return -1;
  Out out{out_buf, cap};
  double box[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
  for (int i = 0; i < dim; ++i)
    for (int j = 0; j < dim; ++j) box[i][j] = cell[i * dim + j];
  auto colnorm = [&](int j) {
    return std::sqrt(box[0][j] * box[0][j] + box[1][j] * box[1][j] +
                     box[2][j] * box[2][j]);
  };

  char row[kMaxRow];
  out.put("ITEM: TIMESTEP\n");
  out.put(row, fmt_ll(row, step) - row);
  out.put("\nITEM: NUMBER OF ATOMS\n");
  out.put(row, fmt_ll(row, n) - row);
  out.put("\n");
  if (dim == 2) {
    out.put("ITEM: BOX BOUNDS xy pp pp\n");
    bounds_line(out, 0.0, colnorm(0), &box[0][1]);
    bounds_line(out, 0.0, colnorm(1), nullptr);
    bounds_line(out, 0.0, 1.0, nullptr);
    out.put("ITEM: ATOMS id type radius x y xu yu\n");
  } else {
    out.put("ITEM: BOX BOUNDS xy xz yz pp pp pp\n");
    bounds_line(out, 0.0, colnorm(0), &box[0][1]);
    bounds_line(out, 0.0, colnorm(1), &box[1][2]);
    bounds_line(out, 0.0, colnorm(2), &box[0][2]);
    out.put("ITEM: ATOMS id type radius x y z xu yu zu\n");
  }

  for (long long i = 0; i < n; ++i) {
    const double* p = positions + i * dim;
    const int32_t* im = images + i * dim;
    double uw[3];
    for (int k = 0; k < dim; ++k) uw[k] = p[k];
    for (int j = 0; j < dim; ++j)
      for (int k = 0; k < dim; ++k)
        uw[k] = uw[k] + static_cast<double>(im[j]) * box[k][j];
    char* q = fmt_ll(row, i + 1);
    std::memcpy(q, " 1 ", 3);
    q += 3;
    q = fmt_f6(q, diameters[i] / 2.0);
    for (int k = 0; k < dim; ++k) {
      *q++ = ' ';
      q = fmt_f6(q, p[k]);
    }
    for (int k = 0; k < dim; ++k) {
      *q++ = ' ';
      q = fmt_f6(q, uw[k]);
    }
    *q++ = '\n';
    out.put(row, q - row);
  }
  return out.len;
}

}  // extern "C"
