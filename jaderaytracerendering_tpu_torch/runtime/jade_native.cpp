// Native scene runtime for jaderaytracerendering_tpu.
//
// The reference's host-side scene pipeline is C++ (readObj
// PathTrace.cpp:366-466, buildBVHwithSAH PathTrace.cpp:532-663); this
// library is the TPU build's equivalent native runtime: a fast SAH/median
// BVH builder and a Wavefront-OBJ parser, exposed with a C ABI consumed
// via ctypes (accel/native.py, scene/objloader.py). Semantics match the
// NumPy implementations exactly (equivalence-tested in
// tests/test_native.py):
//  - full-sort SAH with cost 2*(xy+xz+yz) * count per side, best split
//    over all three centroid-sorted axes (PathTrace.cpp:580-612);
//  - leaves hold <= leaf_size triangles; node 0 is the reference's
//    garbage sentinel and the root is node 1 (PathTrace.cpp:1078-1084);
//  - children are numbered depth-first, left subtree fully before right,
//    matching the reference's recursion order.
//
// Build: runtime/build.sh -> libjade_native.so

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

constexpr double kInf = 2147483647.0;  // PathTrace.cu:23
constexpr double kBig = 1145141919.0;  // AABB init (PathTrace.cpp:503-504)

struct BuildCtx {
  const float* p1;
  const float* p2;
  const float* p3;
  int64_t t;
  int32_t leaf_size;
  int32_t method;  // 0 = sah, 1 = median
  std::vector<int64_t> order;
  std::vector<Vec3> lo, hi, centroid;
  // output SoA
  std::vector<int32_t> left, right, n, index;
  std::vector<float> aa, bb;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline double half_area2(const Vec3& lo, const Vec3& hi) {
  double lx = hi.x - lo.x, ly = hi.y - lo.y, lz = hi.z - lo.z;
  return 2.0 * (lx * ly + lx * lz + ly * lz);
}

int64_t new_node(BuildCtx& c, int64_t l, int64_t r) {
  int64_t id = static_cast<int64_t>(c.left.size());
  c.left.push_back(0);
  c.right.push_back(0);
  c.n.push_back(0);
  c.index.push_back(0);
  Vec3 lo{kBig, kBig, kBig}, hi{-kBig, -kBig, -kBig};
  for (int64_t i = l; i <= r; ++i) {
    lo = vmin(lo, c.lo[c.order[i]]);
    hi = vmax(hi, c.hi[c.order[i]]);
  }
  c.aa.insert(c.aa.end(), {static_cast<float>(lo.x), static_cast<float>(lo.y),
                           static_cast<float>(lo.z)});
  c.bb.insert(c.bb.end(), {static_cast<float>(hi.x), static_cast<float>(hi.y),
                           static_cast<float>(hi.z)});
  return id;
}

struct Frame {
  int64_t l, r, parent;
  int32_t slot;  // 0 = left child of parent, 1 = right
};

void build_range(BuildCtx& c, int64_t l0, int64_t r0) {
  std::vector<Frame> stack;
  stack.push_back({l0, r0, -1, 0});
  std::vector<double> lsweep, rsweep;  // per-axis prefix costs
  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    int64_t nid = new_node(c, f.l, f.r);
    if (f.parent >= 0) {
      if (f.slot == 0)
        c.left[f.parent] = static_cast<int32_t>(nid);
      else
        c.right[f.parent] = static_cast<int32_t>(nid);
    }
    int64_t count = f.r - f.l + 1;
    if (count <= c.leaf_size) {
      c.n[nid] = static_cast<int32_t>(count);
      c.index[nid] = static_cast<int32_t>(f.l);
      continue;
    }

    int64_t split = (f.l + f.r) / 2;
    auto ids = c.order.begin();
    if (c.method == 0) {
      double best_cost = kInf;
      int best_axis = 0;
      int64_t best_split = split;
      std::vector<int64_t> best_sorted;
      std::vector<Vec3> lmin(count), lmax(count), rmin(count), rmax(count);
      for (int axis = 0; axis < 3; ++axis) {
        std::stable_sort(ids + f.l, ids + f.r + 1,
                         [&](int64_t a, int64_t b) {
                           const Vec3& ca = c.centroid[a];
                           const Vec3& cb = c.centroid[b];
                           double va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                           double vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
                           return va < vb;
                         });
        // prefix / suffix AABB sweeps (PathTrace.cpp:543-575)
        Vec3 lo{kInf, kInf, kInf}, hi{-kInf, -kInf, -kInf};
        for (int64_t i = 0; i < count; ++i) {
          int64_t tid = c.order[f.l + i];
          lo = vmin(lo, c.lo[tid]);
          hi = vmax(hi, c.hi[tid]);
          lmin[i] = lo;
          lmax[i] = hi;
        }
        lo = {kInf, kInf, kInf};
        hi = {-kInf, -kInf, -kInf};
        for (int64_t i = count - 1; i >= 0; --i) {
          int64_t tid = c.order[f.l + i];
          lo = vmin(lo, c.lo[tid]);
          hi = vmax(hi, c.hi[tid]);
          rmin[i] = lo;
          rmax[i] = hi;
        }
        double cost = kInf;
        int64_t spl = f.l;
        for (int64_t i = 0; i < count - 1; ++i) {
          double total = half_area2(lmin[i], lmax[i]) * (double)(i + 1) +
                         half_area2(rmin[i + 1], rmax[i + 1]) * (double)(count - 1 - i);
          if (total < cost) {
            cost = total;
            spl = f.l + i;
          }
        }
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_split = spl;
          best_sorted.assign(ids + f.l, ids + f.r + 1);
        }
      }
      std::copy(best_sorted.begin(), best_sorted.end(), ids + f.l);
      split = best_split;
      (void)best_axis;
    } else {
      // midpoint builder (PathTrace.cpp:469-529): longest axis
      Vec3 lo{kInf, kInf, kInf}, hi{-kInf, -kInf, -kInf};
      for (int64_t i = f.l; i <= f.r; ++i) {
        lo = vmin(lo, c.lo[c.order[i]]);
        hi = vmax(hi, c.hi[c.order[i]]);
      }
      double ex = hi.x - lo.x, ey = hi.y - lo.y, ez = hi.z - lo.z;
      int axis = (ex >= ey && ex >= ez) ? 0 : (ey >= ez ? 1 : 2);
      std::stable_sort(ids + f.l, ids + f.r + 1, [&](int64_t a, int64_t b) {
        const Vec3& ca = c.centroid[a];
        const Vec3& cb = c.centroid[b];
        double va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
        double vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
        return va < vb;
      });
      split = (f.l + f.r) / 2;
    }
    // push right first so the left child is numbered first (DFS order)
    stack.push_back({split + 1, f.r, nid, 1});
    stack.push_back({f.l, split, nid, 0});
  }
}

}  // namespace

extern "C" {

int64_t jade_build_bvh_sah(const float* p1, const float* p2, const float* p3,
                           int64_t t, int32_t leaf_size, int32_t method,
                           int64_t* perm_out, int32_t* left_out,
                           int32_t* right_out, int32_t* n_out,
                           int32_t* index_out, float* aa_out, float* bb_out,
                           int64_t cap) {
  BuildCtx c;
  c.p1 = p1;
  c.p2 = p2;
  c.p3 = p3;
  c.t = t;
  c.leaf_size = leaf_size > 0 ? leaf_size : 8;
  c.method = method;
  c.order.resize(t);
  c.lo.resize(t);
  c.hi.resize(t);
  c.centroid.resize(t);
  for (int64_t i = 0; i < t; ++i) {
    c.order[i] = i;
    Vec3 a{p1[3 * i], p1[3 * i + 1], p1[3 * i + 2]};
    Vec3 b{p2[3 * i], p2[3 * i + 1], p2[3 * i + 2]};
    Vec3 d{p3[3 * i], p3[3 * i + 1], p3[3 * i + 2]};
    c.lo[i] = vmin(a, vmin(b, d));
    c.hi[i] = vmax(a, vmax(b, d));
    c.centroid[i] = {(a.x + b.x + d.x) / 3.0, (a.y + b.y + d.y) / 3.0,
                     (a.z + b.z + d.z) / 3.0};
  }
  // sentinel node 0 (PathTrace.cu:1557-1563)
  c.left.push_back(255);
  c.right.push_back(128);
  c.n.push_back(30);
  c.index.push_back(0);
  c.aa.insert(c.aa.end(), {1.f, 1.f, 0.f});
  c.bb.insert(c.bb.end(), {0.f, 1.f, 0.f});

  if (t > 0) build_range(c, 0, t - 1);

  int64_t k = static_cast<int64_t>(c.left.size());
  if (k > cap) return -1;  // caller buffer too small
  std::memcpy(perm_out, c.order.data(), sizeof(int64_t) * t);
  std::memcpy(left_out, c.left.data(), sizeof(int32_t) * k);
  std::memcpy(right_out, c.right.data(), sizeof(int32_t) * k);
  std::memcpy(n_out, c.n.data(), sizeof(int32_t) * k);
  std::memcpy(index_out, c.index.data(), sizeof(int32_t) * k);
  std::memcpy(aa_out, c.aa.data(), sizeof(float) * 3 * k);
  std::memcpy(bb_out, c.bb.data(), sizeof(float) * 3 * k);
  return k;
}

// ---- OBJ parser -----------------------------------------------------------
// Two-pass C parser matching scene/objloader.py semantics: 'v' records,
// 'f' records with fan triangulation, '#' comments, optional reference-
// compatible '/'->' ' misparse (PathTrace.cpp:388-392). Pass 1 counts,
// pass 2 fills caller buffers.

static int64_t parse_obj_impl(const char* path, double* verts, int64_t* faces,
                              int64_t vcap, int64_t fcap, int32_t compat_slash,
                              int64_t* nv_out, int64_t* nf_out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -2;
  char line[8192];
  int64_t nv = 0, nf = 0;
  while (std::fgets(line, sizeof(line), fp)) {
    char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (*s == '#' || *s == '\0' || *s == '\n') continue;
    if (compat_slash) {
      for (char* q = s; *q; ++q)
        if (*q == '/') *q = ' ';
    }
    if (s[0] == 'v' && (s[1] == ' ' || s[1] == '\t')) {
      double x = 0, y = 0, z = 0;
      if (std::sscanf(s + 1, "%lf %lf %lf", &x, &y, &z) == 3) {
        if (verts) {
          if (nv >= vcap) { std::fclose(fp); return -1; }
          verts[3 * nv] = x;
          verts[3 * nv + 1] = y;
          verts[3 * nv + 2] = z;
        }
        ++nv;
      }
    } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
      // tokenize; each token's leading integer (before any '/') is the
      // vertex index; fan-triangulate polygons
      int64_t idx[64];
      int cnt = 0;
      char* tok = s + 1;
      while (*tok && cnt < 64) {
        while (*tok == ' ' || *tok == '\t') ++tok;
        if (*tok == '\0' || *tok == '\n' || *tok == '\r') break;
        long v = std::strtol(tok, &tok, 10);
        idx[cnt++] = v;
        while (*tok && *tok != ' ' && *tok != '\t' && *tok != '\n') ++tok;
      }
      // compat mode: the reference reads exactly three ints per face
      // record (PathTrace.cpp:403-423), so a slash-replaced
      // 'f a/b/c d/e/f g/h/i' collapses to ONE triangle (a, b, c)
      if (compat_slash && cnt > 3) cnt = 3;
      for (int ki = 1; ki + 1 < cnt; ++ki) {
        if (faces) {
          if (nf >= fcap) { std::fclose(fp); return -1; }
          int64_t tri[3] = {idx[0], idx[ki], idx[ki + 1]};
          for (int j = 0; j < 3; ++j)
            faces[3 * nf + j] = tri[j] > 0 ? tri[j] - 1 : nv + tri[j];
        }
        ++nf;
      }
    }
  }
  std::fclose(fp);
  if (nv_out) *nv_out = nv;
  if (nf_out) *nf_out = nf;
  return 0;
}

int64_t jade_parse_obj_counts(const char* path, int64_t* nv, int64_t* nf,
                              int32_t compat_slash) {
  return parse_obj_impl(path, nullptr, nullptr, 0, 0, compat_slash, nv, nf);
}

int64_t jade_parse_obj(const char* path, double* verts, int64_t* faces,
                       int64_t vcap, int64_t fcap, int32_t compat_slash) {
  int64_t nv = 0, nf = 0;
  int64_t rc = parse_obj_impl(path, verts, faces, vcap, fcap, compat_slash,
                              &nv, &nf);
  return rc < 0 ? rc : nf;
}

}  // extern "C"
