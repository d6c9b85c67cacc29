// Host software rasterizer of the PyTorch port: the synthetic depth of ICP
// and depth re-scoring. A copy of augmentedautoencoder_tpu/renderer/native/
// rasterizer.cpp with the same rendering arithmetic, byte for byte; it
// differs only in how meshes are held:
//   * each registered mesh lives behind its own std::unique_ptr, and the
//     registry is guarded by a mutex, so registering a mesh while other
//     threads render never moves a mesh that a render is reading (the
//     JAX copy keeps Mesh values in a std::vector, whose reallocation in
//     aae_mesh_register leaves a concurrent render's `const Mesh&`
//     dangling);
//   * there is no clear and no stage profiler.
//
// Mirrors raster_numpy.py exactly (which in turn mirrors the reference GL
// pipeline: auto_pose/meshrenderer/meshrenderer_phong.py + depth_shader_phong
// shaders + gl_utils/camera.py realCamera):
//   * OpenCV pinhole projection, z-buffer on eye-space z, near/far clip
//   * per-fragment Phong (positional light in GL-eye coords, no shininess
//     exponent), perspective-correct varyings
//   * outputs BGR uint8 + eye-space z depth float32, background zero
//
// Performance design:
//   * geometry/depth in double (keeps numpy-backend agreement to rtol 1e-5),
//     shading varyings and Phong math in float (the per-pixel hot path)
//   * incremental edge functions: 3 adds per pixel instead of 6 mul + 6 sub
//   * all frame-sized work (depth clear, depth writeback) restricted to the
//     object's projected screen bbox; output buffers arrive pre-zeroed from
//     numpy (np.zeros), so no full-frame clears happen per render
//   * persistent per-thread depth buffer — no per-call allocation
//
// Parallelism: threads own horizontal bands of the image; every thread scans
// all triangles and rasterizes the band intersection (no locks, no atomics).
//
// C ABI only — bound from Python with ctypes (binding.py).
// CONTRACT: out_bgr / out_depth must be zero-initialized by the caller.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

#if defined(__SSE__) || defined(__x86_64__)
#include <immintrin.h>
#define AAE_HAVE_SSE 1
#endif

// 8-wide double span tests + 16-wide float deferred shading (compiled when
// the build host has AVX-512; binding.py builds with -march=native).
#if defined(__AVX512F__) && defined(__AVX512VL__)
#define AAE_AVX512 1
#endif

namespace {

// fast reciprocal square root: hardware estimate + one Newton-Raphson step
// (~22 significant bits — far below the 1/255 color quantum the shading
// output is rounded to)
inline float rsqrt_fast(float x) {
#if defined(AAE_HAVE_SSE)
  float r = _mm_cvtss_f32(_mm_rsqrt_ss(_mm_set_ss(x)));
  return r * (1.5f - 0.5f * x * r * r);
#else
  return 1.0f / std::sqrt(x);
#endif
}

// fast reciprocal (~22 bits): feeds only the f32 shading coefficients,
// whose output is rounded to the 1/255 color quantum
inline float rcp_fast(float x) {
#if defined(AAE_HAVE_SSE)
  float r = _mm_cvtss_f32(_mm_rcp_ss(_mm_set_ss(x)));
  return r * (2.0f - x * r);
#else
  return 1.0f / x;
#endif
}

struct Mesh {
  std::vector<double> verts;    // 3V
  std::vector<double> normals;  // 3V
  std::vector<float> colors;    // 3V in [0,1]
  std::vector<int32_t> faces;   // 3F
  // SoA mirrors, padded to a multiple of 8 (last vertex repeated): the
  // 8-wide vertex stage loads these contiguously
  std::vector<double> vx, vy, vz, nx, ny, nz;
  std::vector<float> cr, cg, cb;
  int n_verts = 0;
  int n_faces = 0;
  // backface culling is output-identical ONLY for closed, consistently
  // wound meshes (every backface hides behind a frontface on every ray).
  // Detected once at register time; cull_sign is the screen-space signed-
  // area sign of front-facing triangles (+1/-1), 0 = don't cull.
  int cull_sign = 0;
};

// Closed + consistently wound <=> every directed edge (a,b) is matched by
// exactly one twin (b,a). Returns true iff that holds.
bool mesh_is_closed_manifold(const std::vector<int32_t>& faces, int n_faces,
                             int n_verts) {
  std::vector<std::pair<uint64_t, int>> edges;
  edges.reserve(static_cast<size_t>(n_faces) * 3);
  for (int fi = 0; fi < n_faces; ++fi) {
    const int32_t* f = &faces[3 * fi];
    for (int e = 0; e < 3; ++e) {
      const uint64_t a = static_cast<uint32_t>(f[e]);
      const uint64_t b = static_cast<uint32_t>(f[(e + 1) % 3]);
      const uint64_t lo = std::min(a, b), hi = std::max(a, b);
      edges.push_back({(lo << 32) | hi, a < b ? +1 : -1});
    }
  }
  std::sort(edges.begin(), edges.end());
  for (size_t i = 0; i < edges.size();) {
    size_t j = i;
    int sum = 0;
    while (j < edges.size() && edges[j].first == edges[i].first) {
      sum += edges[j].second;
      ++j;
    }
    // exactly two half-edges in opposite directions
    if (j - i != 2 || sum != 0) return false;
    i = j;
  }
  return true;
}

// For a consistently wound mesh, decide which winding is "outward" by
// majority vote of geometric vs vertex normals.
int detect_front_winding(const Mesh& m) {
  double vote = 0.0;
  for (int fi = 0; fi < m.n_faces; ++fi) {
    const int32_t* f = &m.faces[3 * fi];
    const double* p0 = &m.verts[3 * f[0]];
    const double* p1 = &m.verts[3 * f[1]];
    const double* p2 = &m.verts[3 * f[2]];
    const double e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
    const double e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
    const double gn[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                          e1[2] * e2[0] - e1[0] * e2[2],
                          e1[0] * e2[1] - e1[1] * e2[0]};
    const double* n0 = &m.normals[3 * f[0]];
    const double* n1 = &m.normals[3 * f[1]];
    const double* n2 = &m.normals[3 * f[2]];
    vote += gn[0] * (n0[0] + n1[0] + n2[0]) + gn[1] * (n0[1] + n1[1] + n2[1]) +
            gn[2] * (n0[2] + n1[2] + n2[2]);
  }
  if (vote == 0.0) return 0;
  return vote > 0.0 ? +1 : -1;
}

// Meshes never move once registered: the vector holds pointers, and only
// the vector itself is guarded.
std::vector<std::unique_ptr<Mesh>> g_meshes;
std::mutex g_meshes_mu;

struct Vec3f {
  float x, y, z;
};

inline Vec3f operator-(Vec3f a, Vec3f b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3f operator+(Vec3f a, Vec3f b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3f operator*(float s, Vec3f a) { return {s * a.x, s * a.y, s * a.z}; }
inline float dot(Vec3f a, Vec3f b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3f normalize(Vec3f a) {
  float n2 = dot(a, a);
  float inv = n2 > 1e-24f ? rsqrt_fast(n2) : 0.0f;
  return {a.x * inv, a.y * inv, a.z * inv};
}

// Per-vertex attributes, split by consumer:
//   VGeo (32 B) -- projected geometry for face setup / sort / span math;
//     z > 1e-9 doubles as the validity flag (invalid verts zero the rest)
//   VShade (one 64 B cache line) -- the 12 shading varyings in lanes 0-11
//     (n, l, view, color); the span loop interpolates ALL of them with
//     three 16-wide FMAs and one aligned store per survivor
struct VGeo {
  double u, v;       // pixel coords
  double z;          // eye-space z (OpenCV convention, >0 in front)
  double inv_z;
};
struct alignas(64) VShade {
  float a[16];
};

#if defined(AAE_AVX512)
// in-register 16x16 f32 transpose (AoS survivor rows -> SoA shading lanes)
inline void transpose16(__m512 m[16]) {
  __m512 t[16];
  for (int i = 0; i < 8; ++i) {
    t[2 * i] = _mm512_unpacklo_ps(m[2 * i], m[2 * i + 1]);
    t[2 * i + 1] = _mm512_unpackhi_ps(m[2 * i], m[2 * i + 1]);
  }
  for (int i = 0; i < 4; ++i) {
    m[4 * i] = _mm512_castpd_ps(_mm512_unpacklo_pd(
        _mm512_castps_pd(t[4 * i]), _mm512_castps_pd(t[4 * i + 2])));
    m[4 * i + 1] = _mm512_castpd_ps(_mm512_unpackhi_pd(
        _mm512_castps_pd(t[4 * i]), _mm512_castps_pd(t[4 * i + 2])));
    m[4 * i + 2] = _mm512_castpd_ps(_mm512_unpacklo_pd(
        _mm512_castps_pd(t[4 * i + 1]), _mm512_castps_pd(t[4 * i + 3])));
    m[4 * i + 3] = _mm512_castpd_ps(_mm512_unpackhi_pd(
        _mm512_castps_pd(t[4 * i + 1]), _mm512_castps_pd(t[4 * i + 3])));
  }
  for (int i = 0; i < 4; ++i) {
    t[i] = _mm512_shuffle_f32x4(m[i], m[i + 4], 0x88);
    t[i + 4] = _mm512_shuffle_f32x4(m[i], m[i + 4], 0xdd);
    t[i + 8] = _mm512_shuffle_f32x4(m[i + 8], m[i + 12], 0x88);
    t[i + 12] = _mm512_shuffle_f32x4(m[i + 8], m[i + 12], 0xdd);
  }
  for (int i = 0; i < 4; ++i) {
    m[i] = _mm512_shuffle_f32x4(t[i], t[i + 8], 0x88);
    m[i + 4] = _mm512_shuffle_f32x4(t[i + 4], t[i + 12], 0x88);
    m[i + 8] = _mm512_shuffle_f32x4(t[i], t[i + 8], 0xdd);
    m[i + 12] = _mm512_shuffle_f32x4(t[i + 4], t[i + 12], 0xdd);
  }
}
#endif

inline Vec3f shade_pixel(Vec3f n, Vec3f l, Vec3f view, Vec3f color, float ambient,
                         float diffuse, float specular) {
  Vec3f N = normalize(n), L = normalize(l), V = normalize(view);
  float ndotl = std::max(dot(N, L), 0.0f);
  Vec3f refl = (2.0f * dot(N, L)) * N - L;
  float rdotv = std::max(dot(refl, V), 0.0f);
  float w = ambient + diffuse * ndotl + specular * rdotv;
  Vec3f rgb = {w * color.x, w * color.y, w * color.z};
  rgb.x = std::min(std::max(rgb.x, 0.0f), 1.0f);
  rgb.y = std::min(std::max(rgb.y, 0.0f), 1.0f);
  rgb.z = std::min(std::max(rgb.z, 0.0f), 1.0f);
  return rgb;
}

}  // namespace

extern "C" {

// Register a mesh; colors may be null (gray-160 fallback). Returns mesh id.
int aae_mesh_register(const double* vertices, const double* normals,
                      const double* colors, int n_vertices,
                      const int32_t* faces, int n_faces) {
  Mesh m;
  m.n_verts = n_vertices;
  m.n_faces = n_faces;
  m.verts.assign(vertices, vertices + 3 * n_vertices);
  m.normals.assign(normals, normals + 3 * n_vertices);
  m.colors.resize(3 * n_vertices);
  if (colors) {
    for (int i = 0; i < 3 * n_vertices; ++i)
      m.colors[i] = static_cast<float>(colors[i] / 255.0);
  } else {
    std::fill(m.colors.begin(), m.colors.end(), 160.0f / 255.0f);
  }
  m.faces.assign(faces, faces + 3 * n_faces);
  if (n_vertices > 0) {
    const int n_pad = (n_vertices + 7) & ~7;
    m.vx.resize(n_pad); m.vy.resize(n_pad); m.vz.resize(n_pad);
    m.nx.resize(n_pad); m.ny.resize(n_pad); m.nz.resize(n_pad);
    m.cr.resize(n_pad); m.cg.resize(n_pad); m.cb.resize(n_pad);
    for (int i = 0; i < n_pad; ++i) {
      const int j = std::min(i, n_vertices - 1);
      m.vx[i] = m.verts[3 * j];
      m.vy[i] = m.verts[3 * j + 1];
      m.vz[i] = m.verts[3 * j + 2];
      m.nx[i] = m.normals[3 * j];
      m.ny[i] = m.normals[3 * j + 1];
      m.nz[i] = m.normals[3 * j + 2];
      m.cr[i] = m.colors[3 * j];
      m.cg[i] = m.colors[3 * j + 1];
      m.cb[i] = m.colors[3 * j + 2];
    }
  }
  if (mesh_is_closed_manifold(m.faces, n_faces, n_vertices)) {
    m.cull_sign = detect_front_winding(m);
  }
  std::lock_guard<std::mutex> lock(g_meshes_mu);
  g_meshes.push_back(std::make_unique<Mesh>(std::move(m)));
  return static_cast<int>(g_meshes.size()) - 1;
}

// Render mesh `mesh_id`; out_bgr is H*W*3 uint8, out_depth H*W float32 —
// both MUST be zero-initialized by the caller (numpy allocates with zeros).
// K, R row-major 3x3; t 3; light_pos 3 (GL-eye coords as in the reference).
// out_px_bbox (4 int32, may be null): [min_x, min_y, max_x, max_y] of the
// depth>0 pixels, or all -1 when nothing is visible — saves the caller a
// full-frame nonzero scan for bbox extraction.
int aae_render(int mesh_id, int W, int H, const double* K, const double* R,
               const double* t, double near_p, double far_p,
               const double* light_pos, double ambient, double diffuse,
               double specular, uint8_t* out_bgr, float* out_depth,
               int32_t* out_px_bbox) {
  if (out_px_bbox) {
    out_px_bbox[0] = out_px_bbox[1] = out_px_bbox[2] = out_px_bbox[3] = -1;
  }
  const Mesh* mesh = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_meshes_mu);
    if (mesh_id < 0 || mesh_id >= static_cast<int>(g_meshes.size())) return -1;
    mesh = g_meshes[mesh_id].get();
  }
  const Mesh& m = *mesh;

  const float amb = static_cast<float>(ambient);
  const float dif = static_cast<float>(diffuse);
  const float spec = static_cast<float>(specular);

  // persistent depth buffer: only the object's bbox region is (re)cleared
  static thread_local std::vector<double> depth_buf;
  if (depth_buf.size() < static_cast<size_t>(W) * H) {
    depth_buf.assign(static_cast<size_t>(W) * H, 1e300);
  }

  // ---- vertex stage (+ projected screen bbox of the whole object)
  // SoA mesh + 8-wide f64 transform/projection (one vdivpd per 8 verts) and
  // 8-wide f32 shading varyings; results interleave into the AoS attribute
  // buffers the face/span stages read (random access per face index -> AoS
  // keeps that to 1-2 cache lines per vertex). Buffers persist per thread.
  static thread_local std::vector<VGeo> geo_buf;
  static thread_local std::vector<VShade> shade_buf;
  const int nv_pad = (m.n_verts + 7) & ~7;
  if (static_cast<int>(geo_buf.size()) < nv_pad) {
    geo_buf.resize(nv_pad);
    shade_buf.resize(nv_pad);
  }
  VGeo* const geo = geo_buf.data();
  VShade* const shade = shade_buf.data();
  const Vec3f light = {static_cast<float>(light_pos[0]),
                       static_cast<float>(light_pos[1]),
                       static_cast<float>(light_pos[2])};
  double obj_u0 = 1e300, obj_u1 = -1e300, obj_v0 = 1e300, obj_v1 = -1e300;
#if defined(AAE_AVX512)
  {
    const __m512d R0 = _mm512_set1_pd(R[0]), R1 = _mm512_set1_pd(R[1]),
                  R2 = _mm512_set1_pd(R[2]), R3 = _mm512_set1_pd(R[3]),
                  R4 = _mm512_set1_pd(R[4]), R5 = _mm512_set1_pd(R[5]),
                  R6 = _mm512_set1_pd(R[6]), R7 = _mm512_set1_pd(R[7]),
                  R8 = _mm512_set1_pd(R[8]);
    const __m512d T0 = _mm512_set1_pd(t[0]), T1 = _mm512_set1_pd(t[1]),
                  T2 = _mm512_set1_pd(t[2]);
    const __m512d Kf0 = _mm512_set1_pd(K[0]), Kf1 = _mm512_set1_pd(K[1]),
                  Kc2 = _mm512_set1_pd(K[2]), Kf4 = _mm512_set1_pd(K[4]),
                  Kc5 = _mm512_set1_pd(K[5]);
    const __m512d epsd = _mm512_set1_pd(1e-9), oned = _mm512_set1_pd(1.0);
    __m512d ulo = _mm512_set1_pd(1e300), uhi = _mm512_set1_pd(-1e300);
    __m512d vlo = _mm512_set1_pd(1e300), vhi = _mm512_set1_pd(-1e300);
    const __m256 lx8 = _mm256_set1_ps(light.x), ly8 = _mm256_set1_ps(light.y),
                 lz8 = _mm256_set1_ps(light.z);
    const __m256 half8 = _mm256_set1_ps(0.5f),
                 threehalf8 = _mm256_set1_ps(1.5f),
                 tiny8 = _mm256_set1_ps(1e-24f), zero8 = _mm256_setzero_ps();
    // 8-wide twin of normalize(): rsqrt estimate + one Newton step (same
    // hardware table as the scalar _mm_rsqrt_ss path)
    auto norm3 = [&](__m256& x, __m256& y, __m256& z) {
      const __m256 n2 =
          _mm256_fmadd_ps(x, x, _mm256_fmadd_ps(y, y, _mm256_mul_ps(z, z)));
      __m256 r = _mm256_rsqrt_ps(n2);
      r = _mm256_mul_ps(r, _mm256_fnmadd_ps(_mm256_mul_ps(half8, n2),
                                            _mm256_mul_ps(r, r), threehalf8));
      r = _mm256_and_ps(r, _mm256_cmp_ps(n2, tiny8, _CMP_GT_OQ));
      x = _mm256_mul_ps(x, r);
      y = _mm256_mul_ps(y, r);
      z = _mm256_mul_ps(z, r);
    };
    for (int i = 0; i < nv_pad; i += 8) {
      const __m512d px = _mm512_loadu_pd(&m.vx[i]);
      const __m512d py = _mm512_loadu_pd(&m.vy[i]);
      const __m512d pz = _mm512_loadu_pd(&m.vz[i]);
      const __m512d x = _mm512_fmadd_pd(
          R0, px, _mm512_fmadd_pd(R1, py, _mm512_fmadd_pd(R2, pz, T0)));
      const __m512d y = _mm512_fmadd_pd(
          R3, px, _mm512_fmadd_pd(R4, py, _mm512_fmadd_pd(R5, pz, T1)));
      const __m512d z = _mm512_fmadd_pd(
          R6, px, _mm512_fmadd_pd(R7, py, _mm512_fmadd_pd(R8, pz, T2)));
      const __mmask8 valid = _mm512_cmp_pd_mask(z, epsd, _CMP_GT_OQ);
      const __m512d iz = _mm512_maskz_div_pd(valid, oned, z);
      const __m512d u = _mm512_maskz_fmadd_pd(
          valid, _mm512_fmadd_pd(Kf0, x, _mm512_mul_pd(Kf1, y)), iz, Kc2);
      const __m512d v =
          _mm512_maskz_fmadd_pd(valid, _mm512_mul_pd(Kf4, y), iz, Kc5);
      ulo = _mm512_mask_min_pd(ulo, valid, ulo, u);
      uhi = _mm512_mask_max_pd(uhi, valid, uhi, u);
      vlo = _mm512_mask_min_pd(vlo, valid, vlo, v);
      vhi = _mm512_mask_max_pd(vhi, valid, vhi, v);
      alignas(64) double tu[8], tv[8], tz[8], tiz[8];
      _mm512_store_pd(tu, u);
      _mm512_store_pd(tv, v);
      _mm512_store_pd(tz, z);
      _mm512_store_pd(tiz, iz);
      const __m512d nxd = _mm512_loadu_pd(&m.nx[i]);
      const __m512d nyd = _mm512_loadu_pd(&m.ny[i]);
      const __m512d nzd = _mm512_loadu_pd(&m.nz[i]);
      __m256 ngx = _mm512_cvtpd_ps(_mm512_fmadd_pd(
          R0, nxd, _mm512_fmadd_pd(R1, nyd, _mm512_mul_pd(R2, nzd))));
      __m256 ngy = _mm512_cvtpd_ps(_mm512_fmadd_pd(
          R3, nxd, _mm512_fmadd_pd(R4, nyd, _mm512_mul_pd(R5, nzd))));
      __m256 ngz = _mm256_sub_ps(zero8, _mm512_cvtpd_ps(_mm512_fmadd_pd(
          R6, nxd, _mm512_fmadd_pd(R7, nyd, _mm512_mul_pd(R8, nzd)))));
      norm3(ngx, ngy, ngz);
      const __m256 xf = _mm512_cvtpd_ps(x);
      const __m256 yf = _mm512_cvtpd_ps(y);
      const __m256 zf = _mm512_cvtpd_ps(z);
      __m256 lxv = _mm256_sub_ps(lx8, xf);
      __m256 lyv = _mm256_sub_ps(ly8, yf);
      __m256 lzv = _mm256_add_ps(lz8, zf);  // light.z - (-z)
      norm3(lxv, lyv, lzv);
      alignas(32) float sn[9][8];
      _mm256_store_ps(sn[0], ngx);
      _mm256_store_ps(sn[1], ngy);
      _mm256_store_ps(sn[2], ngz);
      _mm256_store_ps(sn[3], lxv);
      _mm256_store_ps(sn[4], lyv);
      _mm256_store_ps(sn[5], lzv);
      _mm256_store_ps(sn[6], _mm256_sub_ps(zero8, xf));
      _mm256_store_ps(sn[7], _mm256_sub_ps(zero8, yf));
      _mm256_store_ps(sn[8], zf);
      const int lim = std::min(8, m.n_verts - i);
      for (int k = 0; k < lim; ++k) {
        VGeo& g = geo[i + k];
        g.u = tu[k];
        g.v = tv[k];
        g.z = tz[k];
        g.inv_z = tiz[k];
        float* s = shade[i + k].a;
        s[0] = sn[0][k];
        s[1] = sn[1][k];
        s[2] = sn[2][k];
        s[3] = sn[3][k];
        s[4] = sn[4][k];
        s[5] = sn[5][k];
        s[6] = sn[6][k];
        s[7] = sn[7][k];
        s[8] = sn[8][k];
        s[9] = m.cr[i + k];
        s[10] = m.cg[i + k];
        s[11] = m.cb[i + k];
      }
    }
    alignas(64) double red[8];
    _mm512_store_pd(red, ulo);
    for (int k = 0; k < 8; ++k) obj_u0 = std::min(obj_u0, red[k]);
    _mm512_store_pd(red, uhi);
    for (int k = 0; k < 8; ++k) obj_u1 = std::max(obj_u1, red[k]);
    _mm512_store_pd(red, vlo);
    for (int k = 0; k < 8; ++k) obj_v0 = std::min(obj_v0, red[k]);
    _mm512_store_pd(red, vhi);
    for (int k = 0; k < 8; ++k) obj_v1 = std::max(obj_v1, red[k]);
  }
#else
#pragma omp parallel for schedule(static) \
    reduction(min : obj_u0, obj_v0) reduction(max : obj_u1, obj_v1)
  for (int i = 0; i < m.n_verts; ++i) {
    const double* p = &m.verts[3 * i];
    double x = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + t[0];
    double y = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + t[1];
    double z = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + t[2];
    VGeo& a = geo[i];
    const bool valid = z > 1e-9;
    a.z = z;
    a.inv_z = valid ? 1.0 / z : 0.0;
    // projection reuses inv_z instead of two more ~13-cycle f64 divisions
    // (vs the numpy backend's /z this shifts u,v by <=1 ulp — boundary-pixel
    // effects only, inside the agreement tolerances)
    a.u = valid ? (K[0] * x + K[1] * y) * a.inv_z + K[2] : 0.0;
    a.v = valid ? (K[4] * y) * a.inv_z + K[5] : 0.0;
    if (valid) {
      obj_u0 = std::min(obj_u0, a.u);
      obj_u1 = std::max(obj_u1, a.u);
      obj_v0 = std::min(obj_v0, a.v);
      obj_v1 = std::max(obj_v1, a.v);
    }
    const double* n = &m.normals[3 * i];
    Vec3f n_gl = {static_cast<float>(R[0] * n[0] + R[1] * n[1] + R[2] * n[2]),
                  static_cast<float>(R[3] * n[0] + R[4] * n[1] + R[5] * n[2]),
                  static_cast<float>(-(R[6] * n[0] + R[7] * n[1] + R[8] * n[2]))};
    const Vec3f nn = normalize(n_gl);
    Vec3f p_gl = {static_cast<float>(x), static_cast<float>(y),
                  static_cast<float>(-z)};
    const Vec3f ll = normalize(light - p_gl);
    float* s = shade[i].a;
    s[0] = nn.x; s[1] = nn.y; s[2] = nn.z;
    s[3] = ll.x; s[4] = ll.y; s[5] = ll.z;
    s[6] = static_cast<float>(-x);
    s[7] = static_cast<float>(-y);
    s[8] = static_cast<float>(z);
    s[9] = m.colors[3 * i];
    s[10] = m.colors[3 * i + 1];
    s[11] = m.colors[3 * i + 2];
  }
#endif

  // object's clamped screen bbox — all frame-sized work happens inside it
  const int bb_x0 = std::max(static_cast<int>(std::floor(obj_u0 - 1.0)), 0);
  const int bb_x1 = std::min(static_cast<int>(std::ceil(obj_u1 + 1.0)), W - 1);
  const int bb_y0 = std::max(static_cast<int>(std::floor(obj_v0 - 1.0)), 0);
  const int bb_y1 = std::min(static_cast<int>(std::ceil(obj_v1 + 1.0)), H - 1);
  if (bb_x0 > bb_x1 || bb_y0 > bb_y1) return 0;  // fully off-screen

  // NB: capture the master's buffer pointer — depth_buf is thread_local and
  // must not be re-resolved inside the OpenMP region (worker threads would
  // each get their own empty instance). The buffer stores INVERSE z (a
  // max-buffer): the per-pixel division happens only after the depth test.
  double* const dbuf = depth_buf.data();
  for (int py = bb_y0; py <= bb_y1; ++py) {
    std::fill(&dbuf[static_cast<size_t>(py) * W + bb_x0],
              &dbuf[static_cast<size_t>(py) * W + bb_x1 + 1], 0.0);
  }

  // front-to-back face order: overdrawn fragments fail the depth test
  // BEFORE the (expensive) shading stage. Output-identical — the z-buffer
  // decides visibility either way, so an approximate O(n) bucket sort on
  // quantized z is enough (std::sort costs ~0.4 ms at 5k faces).
  // fused pre-pass: validity + backface cull + approximate front-to-back
  // bucket order in ONE walk over the faces (u,v,z share the VGeo cache
  // line, so the cull test is free here; the raster loop then only ever
  // sees front faces and the bucket sort shrinks accordingly)
  std::vector<int32_t> face_order(m.n_faces);
  int n_front = 0;
  {
    constexpr int kBuckets = 256;
    static thread_local std::vector<int32_t> keep;
    static thread_local std::vector<float> fz;
    if (static_cast<int>(keep.size()) < m.n_faces) {
      keep.resize(m.n_faces);
      fz.resize(m.n_faces);
    }
    // Backface culling is output-identical only while the camera is OUTSIDE
    // the mesh: if the near plane slices the object (some valid vertex at
    // z < near), the visible interior consists of BACK faces, which GL —
    // the reference never enables GL_CULL_FACE — and the numpy backend both
    // render. Detection is fused into the pre-pass (the z's are already in
    // registers, so the common case costs nothing); on detection the
    // pre-pass reruns once with culling off — pathological renders only.
    double csign = static_cast<double>(m.cull_sign);
    float z_lo = 1e30f, z_hi = -1e30f;
    for (bool rerun = true; rerun;) {
      rerun = false;
      n_front = 0;
      z_lo = 1e30f;
      z_hi = -1e30f;
      for (int fi = 0; fi < m.n_faces; ++fi) {
        const int32_t* f = &m.faces[3 * fi];
        const VGeo& g0 = geo[f[0]];
        const VGeo& g1 = geo[f[1]];
        const VGeo& g2 = geo[f[2]];
        if (!(g0.z > 1e-9 && g1.z > 1e-9 && g2.z > 1e-9)) continue;
        if (csign != 0.0 &&
            (g0.z < near_p || g1.z < near_p || g2.z < near_p)) {
          csign = 0.0;  // near-slice: back faces become visible
          rerun = true;
          break;
        }
        const double area =
            (g1.u - g0.u) * (g2.v - g0.v) - (g1.v - g0.v) * (g2.u - g0.u);
        if (std::fabs(area) < 1e-12) continue;
        if (area * csign > 0.0) continue;
        const float z = static_cast<float>(g0.z + g1.z + g2.z);
        keep[n_front] = fi;
        fz[n_front] = z;
        ++n_front;
        z_lo = std::min(z_lo, z);
        z_hi = std::max(z_hi, z);
      }
    }
    const float scale = z_hi > z_lo ? (kBuckets - 1) / (z_hi - z_lo) : 0.0f;
    int counts[kBuckets + 1] = {0};
    static thread_local std::vector<uint8_t> bucket_of;
    if (static_cast<int>(bucket_of.size()) < n_front) bucket_of.resize(m.n_faces);
    for (int k = 0; k < n_front; ++k) {
      const int b = static_cast<int>((fz[k] - z_lo) * scale);
      bucket_of[k] = static_cast<uint8_t>(b);
      ++counts[b + 1];
    }
    for (int b = 0; b < kBuckets; ++b) counts[b + 1] += counts[b];
    for (int k = 0; k < n_front; ++k) {
      face_order[counts[bucket_of[k]]++] = keep[k];
    }
  }
  // ---- raster stage: each thread owns a band of rows
  const double inv_near = 1.0 / std::max(near_p, 1e-30);
  const double inv_far = 1.0 / std::max(far_p, 1e-30);
#pragma omp parallel
  {
#if defined(_OPENMP)
    const int tid = omp_get_thread_num();
    const int nthreads = omp_get_num_threads();
#else
    const int tid = 0;
    const int nthreads = 1;
#endif
    const int rows = bb_y1 - bb_y0 + 1;
    const int band_y0 = bb_y0 + static_cast<int>(static_cast<int64_t>(rows) * tid / nthreads);
    const int band_y1 = bb_y0 + static_cast<int>(static_cast<int64_t>(rows) * (tid + 1) / nthreads) - 1;

#if defined(AAE_AVX512)
    // Deferred shading: each survivor records its 12 interpolated varyings
    // as ONE aligned 64 B row (three 16-wide FMAs over the face's hoisted
    // VShade lines + one store — the round-2 version did 36 scalar FMAs and
    // 13 scattered stores here); the latency-chained part of Phong (three
    // normalizes + dots + byte conversion) runs afterwards 16-wide across
    // survivors via an in-register 16x16 transpose. Shading survivors in
    // record order reproduces immediate-mode output exactly (later faces
    // overwrite, as the scalar path's in-place writes do). Per-thread
    // buffers: bands are disjoint pixel sets. NB: with ~4 px triangles,
    // per-face SIMD cannot win — vectorizing ACROSS survivors is what pays.
    static thread_local std::vector<int32_t> sv_idx;
    static thread_local std::vector<VShade> sv_attr;
    size_t sv_n = 0;
    auto sv_reserve = [&](size_t extra) {
      if (sv_n + extra > sv_idx.size()) {
        const size_t ns = std::max(sv_n + extra, sv_idx.size() * 2 + 4096);
        sv_idx.resize(ns);
        sv_attr.resize(ns);
      }
    };
#endif

    for (int oi = 0; oi < n_front; ++oi) {
      const int fi = face_order[oi];
      const int32_t* f = &m.faces[3 * fi];
      const VGeo& a0 = geo[f[0]];
      const VGeo& a1 = geo[f[1]];
      const VGeo& a2 = geo[f[2]];
      // validity / degeneracy / backface culling already decided in the
      // fused sort pre-pass (screen area > 0 <=> winding's geometric
      // normal points away from the camera under the OpenCV projection;
      // for closed consistently wound meshes skipping those faces is
      // output-identical). Area recompute here is 7 flops on L1-hot data.
      const double area = (a1.u - a0.u) * (a2.v - a0.v) - (a1.v - a0.v) * (a2.u - a0.u);

      int x_min = std::max(static_cast<int>(std::floor(std::min({a0.u, a1.u, a2.u}) - 0.5)), 0);
      int x_max = std::min(static_cast<int>(std::ceil(std::max({a0.u, a1.u, a2.u}) - 0.5)), W - 1);
      int y_min = std::max(static_cast<int>(std::floor(std::min({a0.v, a1.v, a2.v}) - 0.5)), band_y0);
      int y_max = std::min(static_cast<int>(std::ceil(std::max({a0.v, a1.v, a2.v}) - 0.5)), band_y1);
      if (x_min > x_max || y_min > y_max) continue;
      // the ~13-cycle f64 division only runs for faces that survive every
      // cheap reject above
      const double inv_area = 1.0 / area;

      // barycentric weights are affine in pixel coords: evaluate at the
      // corner once, then step. w0(gx,gy) = (A0 + B0*gx + C0*gy) * inv_area
      // with the same algebra as the direct products (expanded form).
      const double B0 = (a2.v - a1.v) * inv_area;   // d w0 / d gx * -1 sign fold
      const double C0 = (a1.u - a2.u) * inv_area;
      const double A0 = (a1.v * a2.u - a1.u * a2.v) * inv_area;
      const double B1 = (a0.v - a2.v) * inv_area;
      const double C1 = (a2.u - a0.u) * inv_area;
      const double A1 = (a2.v * a0.u - a2.u * a0.v) * inv_area;

#if defined(AAE_AVX512)
      // the face's three shading lines stay in registers for the whole span
      const __m512 S0 = _mm512_load_ps(shade[f[0]].a);
      const __m512 S1 = _mm512_load_ps(shade[f[1]].a);
      const __m512 S2 = _mm512_load_ps(shade[f[2]].a);
      const double gx0 = x_min + 0.5;
      // 8-wide row scan: coverage + depth + near/far tests in f64 vectors,
      // masked depth store, then scalar record per surviving lane (ascending
      // px -> identical record order to the scalar loop). The typical row is
      // ~5 slots wide, so one vector iteration replaces the whole row.
      const __m512d lane = _mm512_set_pd(7.0, 6.0, 5.0, 4.0, 3.0, 2.0, 1.0, 0.0);
      const __m512d vB0l = _mm512_mul_pd(_mm512_set1_pd(B0), lane);
      const __m512d vB1l = _mm512_mul_pd(_mm512_set1_pd(B1), lane);
      const __m512d iv0 = _mm512_set1_pd(a0.inv_z);
      const __m512d iv1 = _mm512_set1_pd(a1.inv_z);
      const __m512d iv2 = _mm512_set1_pd(a2.inv_z);
      const __m512d vfar = _mm512_set1_pd(inv_far);
      const __m512d vnear = _mm512_set1_pd(inv_near);
      const __m512d zerod = _mm512_setzero_pd();
      const __m512d onedd = _mm512_set1_pd(1.0);
      for (int py = y_min; py <= y_max; ++py) {
        const double gy = py + 0.5;
        const double w0s = -A0 - B0 * gx0 - C0 * gy;
        const double w1s = -A1 - B1 * gx0 - C1 * gy;
        const size_t row = static_cast<size_t>(py) * W;
        sv_reserve(static_cast<size_t>(x_max - x_min) + 1);
        for (int px = x_min; px <= x_max; px += 8) {
          const int rem = x_max - px + 1;
          const __mmask8 inb = rem >= 8 ? static_cast<__mmask8>(0xFF)
                                        : static_cast<__mmask8>((1u << rem) - 1);
          const double off = static_cast<double>(px - x_min);
          const __m512d w0v =
              _mm512_sub_pd(_mm512_set1_pd(w0s - B0 * off), vB0l);
          const __m512d w1v =
              _mm512_sub_pd(_mm512_set1_pd(w1s - B1 * off), vB1l);
          const __m512d w2v =
              _mm512_sub_pd(_mm512_sub_pd(onedd, w0v), w1v);
          __mmask8 cov = inb & _mm512_cmp_pd_mask(w0v, zerod, _CMP_GE_OQ) &
                         _mm512_cmp_pd_mask(w1v, zerod, _CMP_GE_OQ) &
                         _mm512_cmp_pd_mask(w2v, zerod, _CMP_GE_OQ);
          if (!cov) continue;
          const __m512d izv = _mm512_fmadd_pd(
              w0v, iv0, _mm512_fmadd_pd(w1v, iv1, _mm512_mul_pd(w2v, iv2)));
          const __m512d dold = _mm512_maskz_loadu_pd(cov, &dbuf[row + px]);
          cov &= _mm512_cmp_pd_mask(izv, dold, _CMP_GT_OQ) &
                 _mm512_cmp_pd_mask(izv, vfar, _CMP_GE_OQ) &
                 _mm512_cmp_pd_mask(izv, vnear, _CMP_LE_OQ);
          if (!cov) continue;
          _mm512_mask_storeu_pd(&dbuf[row + px], cov, izv);
          alignas(64) double w0a[8], w1a[8], w2a[8], iza[8];
          _mm512_store_pd(w0a, w0v);
          _mm512_store_pd(w1a, w1v);
          _mm512_store_pd(w2a, w2v);
          _mm512_store_pd(iza, izv);
          unsigned mask = cov;
          while (mask) {
            const int b = __builtin_ctz(mask);
            mask &= mask - 1;
            // ~22-bit reciprocal: the c's only feed f32 shading, rounded
            // to the 1/255 color quantum
            const float rec = rcp_fast(static_cast<float>(iza[b]));
            const float c0 = static_cast<float>(w0a[b] * a0.inv_z) * rec;
            const float c1 = static_cast<float>(w1a[b] * a1.inv_z) * rec;
            const float c2 = static_cast<float>(w2a[b] * a2.inv_z) * rec;
            __m512 attr = _mm512_mul_ps(_mm512_set1_ps(c0), S0);
            attr = _mm512_fmadd_ps(_mm512_set1_ps(c1), S1, attr);
            attr = _mm512_fmadd_ps(_mm512_set1_ps(c2), S2, attr);
            sv_idx[sv_n] = static_cast<int32_t>(row + px + b);
            _mm512_store_ps(sv_attr[sv_n].a, attr);
            ++sv_n;
          }
        }
      }
#else
      const double gx0 = x_min + 0.5;
      for (int py = y_min; py <= y_max; ++py) {
        const double gy = py + 0.5;
        // w0 = A0 - B0*gx - C0*gy ... verify sign by original formula:
        // orig w0 = ((a1.u-gx)(a2.v-gy) - (a1.v-gy)(a2.u-gx)) * inv_area
        //        = (a1.u*a2.v - a1.v*a2.u - gx*(a2.v-a1.v) - gy*(a1.u-a2.u)) * ia
        double w0 = -A0 - B0 * gx0 - C0 * gy;
        double w1 = -A1 - B1 * gx0 - C1 * gy;
        const size_t row = static_cast<size_t>(py) * W;
        // row coverage is an interval (each w is a monotone sequence under
        // the incremental update): first rejection after entry ends the row
        bool entered = false;
        for (int px = x_min; px <= x_max; ++px, w0 -= B0, w1 -= B1) {
          const double w2 = 1.0 - w0 - w1;
          if (w0 < 0.0 || w1 < 0.0 || w2 < 0.0) {
            if (entered) break;
            continue;
          }
          entered = true;

          const double iz = w0 * a0.inv_z + w1 * a1.inv_z + w2 * a2.inv_z;
          // depth + near/far tests on inverse z — no division needed:
          // z in [near, far] <=> iz in [1/far, 1/near]; z < z_buf <=> iz > izb
          const size_t idx = row + px;
          if (iz <= dbuf[idx] || iz < inv_far || iz > inv_near) continue;
          dbuf[idx] = iz;

          // perspective-correct varying interpolation (float: shading only)
          const float rec = rcp_fast(static_cast<float>(iz));
          const float c0 = static_cast<float>(w0 * a0.inv_z) * rec;
          const float c1 = static_cast<float>(w1 * a1.inv_z) * rec;
          const float c2 = static_cast<float>(w2 * a2.inv_z) * rec;
          const float* s0 = shade[f[0]].a;
          const float* s1 = shade[f[1]].a;
          const float* s2 = shade[f[2]].a;
          auto lerp3 = [&](int q) -> Vec3f {
            return {c0 * s0[q] + c1 * s1[q] + c2 * s2[q],
                    c0 * s0[q + 1] + c1 * s1[q + 1] + c2 * s2[q + 1],
                    c0 * s0[q + 2] + c1 * s1[q + 2] + c2 * s2[q + 2]};
          };
          Vec3f rgb = shade_pixel(lerp3(0), lerp3(3), lerp3(6), lerp3(9),
                                  amb, dif, spec);
          out_bgr[3 * idx + 0] = static_cast<uint8_t>(std::lround(rgb.z * 255.0f));
          out_bgr[3 * idx + 1] = static_cast<uint8_t>(std::lround(rgb.y * 255.0f));
          out_bgr[3 * idx + 2] = static_cast<uint8_t>(std::lround(rgb.x * 255.0f));
        }
      }
#endif
    }

#if defined(AAE_AVX512)
    // ---- deferred shading: 16 survivors per iteration — normalize N/L/V,
    // Phong, byte conversion (the vector twin of shade_pixel; rsqrt14+Newton
    // vs the scalar SSE rsqrt+Newton differ far below the 1/255 quantum)
    {
      const __m512 fzero = _mm512_setzero_ps();
      const __m512 fone = _mm512_set1_ps(1.0f);
      const __m512 fhalf = _mm512_set1_ps(0.5f);
      const __m512 f3half = _mm512_set1_ps(1.5f);
      const __m512 f255 = _mm512_set1_ps(255.0f);
      const __m512 vamb = _mm512_set1_ps(amb);
      const __m512 vdif = _mm512_set1_ps(dif);
      const __m512 vspec = _mm512_set1_ps(spec);
      const __m512 tiny = _mm512_set1_ps(1e-24f);
      auto vnormalize = [&](__m512& x, __m512& y, __m512& z) {
        const __m512 n2 = _mm512_fmadd_ps(
            x, x, _mm512_fmadd_ps(y, y, _mm512_mul_ps(z, z)));
        __m512 r = _mm512_rsqrt14_ps(n2);
        r = _mm512_mul_ps(
            r, _mm512_fnmadd_ps(_mm512_mul_ps(fhalf, n2),
                                _mm512_mul_ps(r, r), f3half));
        r = _mm512_maskz_mov_ps(_mm512_cmp_ps_mask(n2, tiny, _CMP_GT_OQ), r);
        x = _mm512_mul_ps(x, r);
        y = _mm512_mul_ps(y, r);
        z = _mm512_mul_ps(z, r);
      };

      for (size_t i = 0; i < sv_n; i += 16) {
        const size_t rem = sv_n - i;
        const size_t n_lane = rem >= 16 ? 16 : rem;
        // AoS survivor rows -> SoA lanes in registers; tail lanes duplicate
        // the last survivor (their outputs are never scattered)
        __m512 rows[16];
        for (size_t j = 0; j < 16; ++j) {
          rows[j] = _mm512_load_ps(sv_attr[i + (j < n_lane ? j : n_lane - 1)].a);
        }
        transpose16(rows);
        __m512 Nx = rows[0], Ny = rows[1], Nz = rows[2];
        __m512 Lx = rows[3], Ly = rows[4], Lz = rows[5];
        __m512 Vx = rows[6], Vy = rows[7], Vz = rows[8];
        const __m512 colr = rows[9], colg = rows[10], colb = rows[11];
        vnormalize(Nx, Ny, Nz);
        vnormalize(Lx, Ly, Lz);
        vnormalize(Vx, Vy, Vz);
        const __m512 ndl_raw = _mm512_fmadd_ps(
            Nx, Lx, _mm512_fmadd_ps(Ny, Ly, _mm512_mul_ps(Nz, Lz)));
        const __m512 ndl = _mm512_max_ps(ndl_raw, fzero);
        const __m512 two_ndl = _mm512_add_ps(ndl_raw, ndl_raw);
        const __m512 Rx = _mm512_fmsub_ps(two_ndl, Nx, Lx);
        const __m512 Ry = _mm512_fmsub_ps(two_ndl, Ny, Ly);
        const __m512 Rz = _mm512_fmsub_ps(two_ndl, Nz, Lz);
        const __m512 rdv = _mm512_max_ps(
            _mm512_fmadd_ps(Rx, Vx,
                            _mm512_fmadd_ps(Ry, Vy, _mm512_mul_ps(Rz, Vz))),
            fzero);
        const __m512 w = _mm512_fmadd_ps(
            vspec, rdv, _mm512_fmadd_ps(vdif, ndl, vamb));
        auto to_byte = [&](__m512 col) {
          const __m512 c = _mm512_min_ps(
              _mm512_max_ps(_mm512_mul_ps(w, col), fzero), fone);
          // lround for non-negatives == floor(x + 0.5): add then truncate
          return _mm512_cvttps_epi32(_mm512_fmadd_ps(c, f255, fhalf));
        };
        alignas(64) int32_t rr[16], gg[16], bbv[16];
        _mm512_store_si512(reinterpret_cast<__m512i*>(rr), to_byte(colr));
        _mm512_store_si512(reinterpret_cast<__m512i*>(gg), to_byte(colg));
        _mm512_store_si512(reinterpret_cast<__m512i*>(bbv), to_byte(colb));
        for (size_t j = 0; j < n_lane; ++j) {
          const size_t idx = static_cast<size_t>(sv_idx[i + j]);
          out_bgr[3 * idx + 0] = static_cast<uint8_t>(bbv[j]);
          out_bgr[3 * idx + 1] = static_cast<uint8_t>(gg[j]);
          out_bgr[3 * idx + 2] = static_cast<uint8_t>(rr[j]);
        }
      }
    }
#endif
  }

  int px_x0 = W, px_x1 = -1, px_y0 = H, px_y1 = -1;
#if defined(AAE_AVX512)
  {
    const __m512d vzero = _mm512_setzero_pd();
    const __m512d vone = _mm512_set1_pd(1.0);
    for (int py = bb_y0; py <= bb_y1; ++py) {
      const size_t row = static_cast<size_t>(py) * W;
      for (int px = bb_x0; px <= bb_x1; px += 8) {
        const int rem = bb_x1 - px + 1;
        const __mmask8 inb =
            rem >= 8 ? static_cast<__mmask8>(0xFF)
                     : static_cast<__mmask8>((1u << rem) - 1);
        const __m512d izb = _mm512_maskz_loadu_pd(inb, &dbuf[row + px]);
        const __mmask8 vis =
            inb & _mm512_cmp_pd_mask(izb, vzero, _CMP_GT_OQ);
        if (!vis) continue;
        const __m512d z = _mm512_maskz_div_pd(vis, vone, izb);
        _mm256_mask_storeu_ps(&out_depth[row + px], vis,
                              _mm512_cvtpd_ps(z));
        px_x0 = std::min(px_x0, px + __builtin_ctz(vis));
        px_x1 = std::max(px_x1, px + 31 - __builtin_clz(vis));
        px_y0 = std::min(px_y0, py);
        px_y1 = std::max(px_y1, py);
      }
    }
  }
#else
  for (int py = bb_y0; py <= bb_y1; ++py) {
    const size_t row = static_cast<size_t>(py) * W;
    for (int px = bb_x0; px <= bb_x1; ++px) {
      const double izb = dbuf[row + px];
      if (izb > 0.0) {
        out_depth[row + px] = static_cast<float>(1.0 / izb);
        px_x0 = std::min(px_x0, px);
        px_x1 = std::max(px_x1, px);
        px_y0 = std::min(px_y0, py);
        px_y1 = std::max(px_y1, py);
      }
    }
  }
#endif
  if (out_px_bbox && px_x1 >= 0) {
    out_px_bbox[0] = px_x0;
    out_px_bbox[1] = px_y0;
    out_px_bbox[2] = px_x1;
    out_px_bbox[3] = px_y1;
  }
  return 0;
}

}  // extern "C"
