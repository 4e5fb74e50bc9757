// Multi-resolution isosurface extraction (MISE) + marching tetrahedra.
//
// Native host-side companion to the TPU field: the octree-style refinement is
// inherently sequential/pointer-chasing, so it runs in C++ between training
// epochs while the SDF evaluations batch onto the device.  Role parity with
// the reference's Cython extension (code/src/libmise/mise.pyx) and skimage
// marching cubes (code/src/utils/meshing.py:51), implemented from scratch:
// coarse dense grid -> iteratively subdivide sign-crossing voxels -> extract
// the final surface with marching tetrahedra (table-free, watertight).
//
// C ABI consumed from Python via ctypes (no pybind11 in the toolchain).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
  int64_t v;
};

inline int64_t key(int64_t x, int64_t y, int64_t z, int64_t res) {
  return (x * (res + 1) + y) * (res + 1) + z;
}

struct Voxel {
  int32_t x, y, z;  // lower corner in finest-grid coordinates
  int32_t size;     // edge length in finest-grid units
};

struct Mise {
  int32_t res0;        // coarse resolution (number of voxels per axis)
  int32_t depth;       // number of subdivision rounds
  int32_t level;       // current round (0 = coarse)
  double iso;
  int64_t res;         // finest grid resolution = res0 << depth
  std::vector<Voxel> active;      // voxels awaiting corner evaluation
  std::vector<Voxel> leaf;        // finest-level voxels with known corners
  std::unordered_map<int64_t, double> values;  // finest-grid point -> sdf
  std::vector<int64_t> pending;   // points needing evaluation (x,y,z triples)

  void collect_pending() {
    pending.clear();
    std::unordered_map<int64_t, bool> seen;
    for (const Voxel& v : active) {
      for (int dx = 0; dx <= 1; ++dx)
        for (int dy = 0; dy <= 1; ++dy)
          for (int dz = 0; dz <= 1; ++dz) {
            int64_t x = v.x + (int64_t)dx * v.size;
            int64_t y = v.y + (int64_t)dy * v.size;
            int64_t z = v.z + (int64_t)dz * v.size;
            int64_t k = key(x, y, z, res);
            if (values.count(k) || seen.count(k)) continue;
            seen[k] = true;
            pending.push_back(x);
            pending.push_back(y);
            pending.push_back(z);
          }
    }
  }

  bool crossing(const Voxel& v) const {
    bool pos = false, neg = false;
    for (int dx = 0; dx <= 1; ++dx)
      for (int dy = 0; dy <= 1; ++dy)
        for (int dz = 0; dz <= 1; ++dz) {
          int64_t k = key(v.x + (int64_t)dx * v.size, v.y + (int64_t)dy * v.size,
                          v.z + (int64_t)dz * v.size, res);
          auto it = values.find(k);
          if (it == values.end()) return false;
          if (it->second > iso) pos = true; else neg = true;
        }
    return pos && neg;
  }

  // after corner values arrive: keep crossing voxels, subdivide or finalize
  bool refine() {
    std::vector<Voxel> next;
    for (const Voxel& v : active) {
      if (!crossing(v)) continue;
      if (v.size == 1) {
        leaf.push_back(v);
        continue;
      }
      int32_t h = v.size / 2;
      for (int dx = 0; dx <= 1; ++dx)
        for (int dy = 0; dy <= 1; ++dy)
          for (int dz = 0; dz <= 1; ++dz)
            next.push_back({v.x + dx * h, v.y + dy * h, v.z + dz * h, h});
    }
    active = std::move(next);
    ++level;
    if (active.empty()) return false;
    if (level > depth) {
      // all remaining are finest-level; move to leaves
      for (const Voxel& v : active) leaf.push_back(v);
      active.clear();
      return false;
    }
    return true;
  }
};

// 6-tetrahedra decomposition of the cube about the main diagonal 0-7
// (corner c = (x + (c&1), y + ((c>>1)&1), z + ((c>>2)&1))); the middle pair
// walks the edge cycle 1-3-2-6-4-5-1 so adjacent tets share faces.
const int TETS6[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

struct MeshBuilder {
  std::unordered_map<int64_t, int64_t> edge_vertex;  // edge key -> vertex idx
  std::vector<double> verts;   // x,y,z triples (finest-grid coordinates)
  std::vector<int64_t> faces;

  int64_t edge_point(int64_t ka, int64_t kb, double va, double vb,
                     const double pa[3], const double pb[3], double iso) {
    int64_t lo = ka < kb ? ka : kb;
    int64_t hi = ka < kb ? kb : ka;
    // key mix (fits: grid keys < 2^42)
    int64_t ek = lo * 0x9E3779B97F4A7C15LL ^ hi;
    auto it = edge_vertex.find(ek);
    if (it != edge_vertex.end()) return it->second;
    double t = (iso - va) / (vb - va);
    if (!(t >= 0.0)) t = 0.0;
    if (!(t <= 1.0)) t = 1.0;
    int64_t idx = (int64_t)(verts.size() / 3);
    for (int d = 0; d < 3; ++d) verts.push_back(pa[d] + t * (pb[d] - pa[d]));
    edge_vertex[ek] = idx;
    return idx;
  }

  // marching tetrahedra for one tet; "inside" = value < iso (SDF convention),
  // faces wound so normals point outward (toward increasing SDF)
  void do_tet(const int64_t k[4], const double val[4], const double pos[4][3],
              double iso) {
    int inside_mask = 0;
    for (int i = 0; i < 4; ++i)
      if (val[i] < iso) inside_mask |= (1 << i);
    if (inside_mask == 0 || inside_mask == 15) return;

    auto ep = [&](int a, int b) {
      return edge_point(k[a], k[b], val[a], val[b], pos[a], pos[b], iso);
    };
    // enumerate the 14 non-trivial cases
    auto tri = [&](int64_t a, int64_t b, int64_t c) {
      faces.push_back(a); faces.push_back(b); faces.push_back(c);
    };
    switch (inside_mask) {
      case 1:  tri(ep(0,1), ep(0,2), ep(0,3)); break;
      case 2:  tri(ep(1,0), ep(1,3), ep(1,2)); break;
      case 3:  tri(ep(0,2), ep(0,3), ep(1,3));
               tri(ep(0,2), ep(1,3), ep(1,2)); break;
      case 4:  tri(ep(2,0), ep(2,1), ep(2,3)); break;
      case 5:  tri(ep(0,1), ep(2,1), ep(0,3));
               tri(ep(2,1), ep(2,3), ep(0,3)); break;
      case 6:  tri(ep(1,0), ep(1,3), ep(2,0));
               tri(ep(1,3), ep(2,3), ep(2,0)); break;
      case 7:  tri(ep(0,3), ep(1,3), ep(2,3)); break;
      case 8:  tri(ep(3,0), ep(3,2), ep(3,1)); break;
      case 9:  tri(ep(0,1), ep(0,2), ep(3,2));
               tri(ep(0,1), ep(3,2), ep(3,1)); break;
      case 10: tri(ep(1,0), ep(3,0), ep(1,2));
               tri(ep(3,0), ep(3,2), ep(1,2)); break;
      case 11: tri(ep(0,2), ep(3,2), ep(1,2)); break;
      case 12: tri(ep(2,0), ep(2,1), ep(3,1));
               tri(ep(2,0), ep(3,1), ep(3,0)); break;
      case 13: tri(ep(0,1), ep(2,1), ep(3,1)); break;
      case 14: tri(ep(1,0), ep(3,0), ep(2,0)); break;
    }
  }
};

}  // namespace

extern "C" {

void* mise_create(int32_t res0, int32_t depth, double iso) {
  Mise* m = new Mise();
  m->res0 = res0;
  m->depth = depth;
  m->level = 0;
  m->iso = iso;
  m->res = (int64_t)res0 << depth;
  int32_t vs = 1 << depth;
  for (int32_t i = 0; i < res0; ++i)
    for (int32_t j = 0; j < res0; ++j)
      for (int32_t k2 = 0; k2 < res0; ++k2)
        m->active.push_back({i * vs, j * vs, k2 * vs, vs});
  m->collect_pending();
  return m;
}

int64_t mise_resolution(void* h) { return ((Mise*)h)->res; }

// returns number of points; writes up to max_n (x,y,z) int64 triples
int64_t mise_query(void* h, int64_t* out, int64_t max_n) {
  Mise* m = (Mise*)h;
  int64_t n = (int64_t)(m->pending.size() / 3);
  if (out && n > 0) {
    int64_t c = n < max_n ? n : max_n;
    std::memcpy(out, m->pending.data(), c * 3 * sizeof(int64_t));
  }
  return n;
}

// feed values for the previously-queried points, then refine one level.
// returns 1 if another query round is needed, 0 when done.
int32_t mise_update(void* h, const int64_t* coords, const double* vals,
                    int64_t n) {
  Mise* m = (Mise*)h;
  for (int64_t i = 0; i < n; ++i) {
    m->values[key(coords[3 * i], coords[3 * i + 1], coords[3 * i + 2], m->res)] =
        vals[i];
  }
  bool more = m->refine();
  if (more) {
    m->collect_pending();
    if (m->pending.empty()) return mise_update(h, nullptr, nullptr, 0);
    return 1;
  }
  m->pending.clear();
  return 0;
}

// extract the surface over leaf voxels; returns vertex count.
// out_verts: (max_v * 3) doubles in finest-grid coords; out_faces:
// (max_f * 3) int64; n_faces receives the face count.
int64_t mise_extract(void* h, double* out_verts, int64_t max_v,
                     int64_t* out_faces, int64_t max_f, int64_t* n_faces) {
  Mise* m = (Mise*)h;
  MeshBuilder mb;
  for (const Voxel& v : m->leaf) {
    int64_t ck[8];
    double cv[8];
    double cp[8][3];
    bool ok = true;
    for (int c = 0; c < 8; ++c) {
      int64_t x = v.x + (int64_t)((c >> 0) & 1) * v.size;
      int64_t y = v.y + (int64_t)((c >> 1) & 1) * v.size;
      int64_t z = v.z + (int64_t)((c >> 2) & 1) * v.size;
      ck[c] = key(x, y, z, m->res);
      auto it = m->values.find(ck[c]);
      if (it == m->values.end()) { ok = false; break; }
      cv[c] = it->second;
      cp[c][0] = (double)x; cp[c][1] = (double)y; cp[c][2] = (double)z;
    }
    if (!ok) continue;
    for (int t = 0; t < 6; ++t) {
      int64_t k4[4]; double v4[4]; double p4[4][3];
      for (int i = 0; i < 4; ++i) {
        int c = TETS6[t][i];
        k4[i] = ck[c]; v4[i] = cv[c];
        for (int d = 0; d < 3; ++d) p4[i][d] = cp[c][d];
      }
      mb.do_tet(k4, v4, p4, m->iso);
    }
  }
  int64_t nv = (int64_t)(mb.verts.size() / 3);
  int64_t nf = (int64_t)(mb.faces.size() / 3);
  if (out_verts) {
    int64_t c = nv < max_v ? nv : max_v;
    std::memcpy(out_verts, mb.verts.data(), c * 3 * sizeof(double));
  }
  if (out_faces) {
    int64_t c = nf < max_f ? nf : max_f;
    std::memcpy(out_faces, mb.faces.data(), c * 3 * sizeof(int64_t));
  }
  if (n_faces) *n_faces = nf;
  return nv;
}

void mise_free(void* h) { delete (Mise*)h; }

}  // extern "C"
