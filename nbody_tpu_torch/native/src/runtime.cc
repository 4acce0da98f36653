// nbody_tpu_torch native host runtime: the host-side pieces the CUDA
// reference wrote in C++ (IC generation loop, result dump, dump parsing;
// nbody_v5.cu:391-447, basics.txt:180-190) as a small C library loaded
// with ctypes, where Python-level text formatting and RNG loops would be
// 50-100x slower at N = 1M.  The same library as nbody_tpu's, kept as
// the port's own copy.
//
// Exposed C ABI:
//   nbt_msvc_rand_fill   bit-exact MSVC LCG rand() stream (srand parity)
//   nbt_disk_galaxy_ic   the v5 initial conditions in one call
//   nbt_write_dump       %.6f text dump writer (output_bh.txt format)
//   nbt_load_dump        parse a dump's numeric rows
//
// Build: nbody_tpu_torch/native/build.py (g++ -O3 -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MSVC LCG: state = state * 214013 + 2531011; output = (state >> 16) & 0x7fff
// ---------------------------------------------------------------------------

void nbt_msvc_rand_fill(uint32_t seed, int64_t count, uint16_t* out) {
  uint32_t s = seed;
  for (int64_t i = 0; i < count; ++i) {
    s = s * 214013u + 2531011u;
    out[i] = (uint16_t)((s >> 16) & 0x7fff);
  }
}

// v5 disk-galaxy ICs (five rand() draws per body in statement order:
// radius, angle, z-offset, mass, z-velocity).  Fills [n] arrays.
// Arithmetic in float, like the reference's float expressions
// (nbody_v5.cu:395-414) and the Python twin (init.disk_galaxy_msvc).
void nbt_disk_galaxy_ic(uint32_t seed, int64_t n, float g,
                        float* px, float* py, float* pz,
                        float* vx, float* vy, float* vz, float* mass) {
  uint32_t s = seed;
  const float TWO_PI = 2.0f * 3.14159265358979323846f;
  auto next = [&]() -> float {
    s = s * 214013u + 2531011u;
    return (float)((s >> 16) & 0x7fff) / 32767.0f;
  };
  for (int64_t i = 0; i < n; ++i) {
    float r = 200.0f + next() * 1500.0f;
    float a = next() * TWO_PI;
    px[i] = r * cosf(a);
    py[i] = r * sinf(a);
    pz[i] = (next() - 0.5f) * (r * 0.05f);
    mass[i] = 2.0f + next() * 5.0f;
    float approx_mass_inside = 50000.0f + r * 100.0f;
    float v_mag = sqrtf(g * approx_mass_inside / r);
    vx[i] = -sinf(a) * v_mag;
    vy[i] = cosf(a) * v_mag;
    vz[i] = (next() - 0.5f) * 2.0f;
  }
}

// ---------------------------------------------------------------------------
// Text dump writer: header + rows of `cols` doubles at %.6f.
// Returns 0 on success, -1 on IO error.
// ---------------------------------------------------------------------------

int nbt_write_dump(const char* path, const char* header,
                   const double* data, int64_t rows, int64_t cols) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  if (header && header[0]) {
    fputs(header, f);
    fputc('\n', f);
  }
  // Buffered manual formatting: ~6x faster than fprintf per field.
  std::vector<char> buf;
  buf.reserve(1 << 22);
  char tmp[64];
  for (int64_t r = 0; r < rows; ++r) {
    for (int64_t c = 0; c < cols; ++c) {
      int len = snprintf(tmp, sizeof tmp, c + 1 == cols ? "%.6f\n" : "%.6f ",
                         data[r * cols + c]);
      buf.insert(buf.end(), tmp, tmp + len);
    }
    if (buf.size() > (1u << 21)) {
      fwrite(buf.data(), 1, buf.size(), f);
      buf.clear();
    }
  }
  if (!buf.empty()) fwrite(buf.data(), 1, buf.size(), f);
  int rc = fclose(f);
  return rc == 0 ? 0 : -1;
}

// Parse numeric rows (skipping '#' lines) into `out` (rows*cols doubles).
// Returns number of rows parsed, or -1 on error / shape mismatch.
int64_t nbt_load_dump(const char* path, double* out, int64_t max_rows,
                      int64_t cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  int64_t r = 0;
  while (fgets(line, sizeof line, f)) {
    if (line[0] == '#' || line[0] == '\n') continue;
    if (r >= max_rows) break;
    char* p = line;
    for (int64_t c = 0; c < cols; ++c) {
      char* end = nullptr;
      out[r * cols + c] = strtod(p, &end);
      if (end == p) { fclose(f); return -1; }
      p = end;
    }
    ++r;
  }
  fclose(f);
  return r;
}

}  // extern "C"
