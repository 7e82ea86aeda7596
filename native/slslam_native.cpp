// slslam native runtime components.
//
// The host-side runtime pieces that the reference implements in C++ and
// that sit off the device compute path: the observation-file loader
// (reference: SLAM::grab_new_frame, src/slam.cpp:62-108) and the
// metric-embedding graph walk (SLAM::metric_embedding,
// src/slam.cpp:1317-1366).  Exposed as a C ABI for ctypes; NumPy arrays are
// passed as raw pointers.
//
// Build: native/build.sh  (g++ -O2 -shared -fPIC)

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <queue>
#include <vector>
#include <utility>

extern "C" {

// ---------------------------------------------------------------------------
// Observation file parsing
// ---------------------------------------------------------------------------

// Parse one line-track file: rows "feature_id x0 y0 x1 y1 x2 y2 x3 y3 extra".
// Writes feature ids to ids[max_rows] and the 8 coords to obs[max_rows*8].
// Returns the number of rows parsed, or -1 if the file cannot be opened.
int slslam_parse_obs_file(const char* path, int* ids, double* obs,
                          int max_rows) {
  FILE* fp = fopen(path, "r");
  if (!fp) return -1;

  char line[512];
  int n = 0;
  while (n < max_rows && fgets(line, sizeof(line), fp)) {
    char* p = line;
    char* end;
    long fid = strtol(p, &end, 10);
    if (end == p) continue;  // blank / malformed line
    p = end;
    double vals[8];
    bool ok = true;
    for (int k = 0; k < 8; ++k) {
      double v = strtod(p, &end);
      if (end == p) { ok = false; break; }
      vals[k] = v;
      p = end;
    }
    if (!ok) continue;
    ids[n] = (int)fid;
    memcpy(obs + 8 * n, vals, sizeof(vals));
    ++n;
  }
  fclose(fp);
  return n;
}

// ---------------------------------------------------------------------------
// Metric embedding (best-first pose-field re-rooting)
// ---------------------------------------------------------------------------

static inline void compose(const double* Ra, const double* ta,
                           const double* Rb, const double* tb,
                           double* Rc, double* tc) {
  // T_c = T_a * T_b  (R_c = Ra Rb, t_c = Ra tb + ta)
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += Ra[3 * i + k] * Rb[3 * k + j];
      Rc[3 * i + j] = s;
    }
    double s = 0;
    for (int k = 0; k < 3; ++k) s += Ra[3 * i + k] * tb[k];
    tc[i] = s + ta[i];
  }
}

// Re-root the pose field at `root`.
//   n_kfs: number of keyframes (ids 0..n_kfs-1; absent ids get valid=0)
//   n_edges: number of DIRECTED edges
//   edge_i, edge_j: endpoints (edge transform maps frame i -> frame j)
//   edge_T: n_edges x 12 row-major (R 9, t 3)
//   order_out: n_kfs ints — kf ids in traversal (distance) order
//   T_out: n_kfs x 12 — embedded world->cam poses
//   valid_out: n_kfs bytes — 1 if reached
// Returns the number of reached keyframes.
int slslam_metric_embedding(int n_kfs, int n_edges, const int* edge_i,
                            const int* edge_j, const double* edge_T,
                            int root, int* order_out, double* T_out,
                            unsigned char* valid_out, double* dist_out) {
  // adjacency: for each node, list of edge indices leaving it
  std::vector<std::vector<int>> adj(n_kfs);
  for (int e = 0; e < n_edges; ++e) {
    int i = edge_i[e];
    if (i >= 0 && i < n_kfs) adj[i].push_back(e);
  }

  memset(valid_out, 0, n_kfs);
  std::vector<double> dist(n_kfs, 0.0);

  // identity at root
  double* Tr = T_out + 12 * root;
  memset(Tr, 0, 12 * sizeof(double));
  Tr[0] = Tr[4] = Tr[8] = 1.0;
  valid_out[root] = 1;

  typedef std::pair<double, int> Item;  // (accumulated distance, kf)
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> pq;
  pq.push(Item(0.0, root));

  std::vector<unsigned char> popped(n_kfs, 0);
  int n_order = 0;

  while (!pq.empty()) {
    Item it = pq.top();
    pq.pop();
    int kid = it.second;
    if (popped[kid]) continue;
    popped[kid] = 1;
    dist_out[n_order] = it.first;
    order_out[n_order++] = kid;

    const double* Tk = T_out + 12 * kid;
    for (size_t a = 0; a < adj[kid].size(); ++a) {
      int e = adj[kid][a];
      int nb = edge_j[e];
      if (nb < 0 || nb >= n_kfs || valid_out[nb]) continue;
      const double* Te = edge_T + 12 * e;
      double* Tn = T_out + 12 * nb;
      // T_nb = T_edge * T_k  (matching slam.cpp:1353-1357: assignment at
      // insertion time using the parent's pose)
      compose(Te, Te + 9, Tk, Tk + 9, Tn, Tn + 9);
      valid_out[nb] = 1;
      double nd = sqrt(Te[9] * Te[9] + Te[10] * Te[10] + Te[11] * Te[11]);
      dist[nb] = it.first + nd;
      pq.push(Item(dist[nb], nb));
    }
  }
  return n_order;
}

// ---------------------------------------------------------------------------
// LSD-style line-segment detection: region growing + rectangle validation
// ---------------------------------------------------------------------------
//
// The per-pixel region-growing BFS is the front-end's hot loop (the
// reference's front-end was never released; frontend/detector.py defines
// the algorithm and keeps a pure-Python fallback).  Semantics must match
// detector.py LineSegmentDetector.detect exactly: anchors in decreasing
// gradient-magnitude order, 8-neighbour growth gated by level-line angle
// against a running mean direction, weighted-PCA rectangle fit, length and
// density validation.

static inline double angdiff2pi(double a, double b) {
  double d = fabs(a - b);
  d = fmod(d, 2.0 * M_PI);
  return d > M_PI ? 2.0 * M_PI - d : d;
}

// Returns the number of segments written (<= max_segments).
//   mag, angle: H*W row-major float32 gradient maps
//   seg_out: max_segments x 4 doubles (x1, y1, x2, y2)
//   grad_out: max_segments x 2 doubles (mean gradient unit vector)
int slslam_lsd_detect(const float* mag, const float* angle, int H, int W,
                      float mag_threshold, float angle_tol,
                      float min_length, float min_density,
                      double* seg_out, double* grad_out, int max_segments) {
  const int n_px = H * W;
  std::vector<unsigned char> used(n_px, 0);
  std::vector<int> anchors;
  anchors.reserve(n_px / 8);
  for (int p = 0; p < n_px; ++p) {
    if (mag[p] >= mag_threshold) anchors.push_back(p);
    else used[p] = 1;
  }
  std::sort(anchors.begin(), anchors.end(),
            [mag](int a, int b) { return mag[a] > mag[b]; });

  static const int dy8[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  static const int dx8[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

  std::vector<int> region;
  region.reserve(4096);
  int n_seg = 0;

  for (size_t ai = 0; ai < anchors.size() && n_seg < max_segments; ++ai) {
    int p0 = anchors[ai];
    if (used[p0]) continue;
    region.clear();
    region.push_back(p0);
    used[p0] = 1;
    double theta = angle[p0];
    double sx = cos(theta), sy = sin(theta);

    for (size_t head = 0; head < region.size(); ++head) {
      int cp = region[head];
      int cy = cp / W, cx = cp % W;
      for (int k = 0; k < 8; ++k) {
        int ny = cy + dy8[k], nx = cx + dx8[k];
        if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
        int np_ = ny * W + nx;
        if (used[np_]) continue;
        if (angdiff2pi(angle[np_], theta) > angle_tol) continue;
        used[np_] = 1;
        region.push_back(np_);
        sx += cos(angle[np_]);
        sy += sin(angle[np_]);
        theta = atan2(sy, sx);
      }
    }

    if ((double)region.size() < min_length) continue;

    // mean gradient direction (level-line angle a -> gradient (sin, -cos))
    double gx = 0, gy = 0;
    for (size_t r = 0; r < region.size(); ++r) {
      double a = angle[region[r]];
      gx += sin(a);
      gy += -cos(a);
    }
    double gn = sqrt(gx * gx + gy * gy);
    if (gn > 0) { gx /= gn; gy /= gn; }

    // weighted PCA of the region's (y, x) coordinates
    double wsum = 0, cy_ = 0, cx_ = 0;
    for (size_t r = 0; r < region.size(); ++r) {
      double w = mag[region[r]];
      wsum += w;
      cy_ += w * (region[r] / W);
      cx_ += w * (region[r] % W);
    }
    cy_ /= wsum;
    cx_ /= wsum;
    double syy = 0, sxx = 0, sxy = 0;
    for (size_t r = 0; r < region.size(); ++r) {
      double w = mag[region[r]] / wsum;
      double dy = (region[r] / W) - cy_;
      double dx = (region[r] % W) - cx_;
      syy += w * dy * dy;
      sxx += w * dx * dx;
      sxy += w * dy * dx;
    }
    // eigen-decomposition of [[syy, sxy], [sxy, sxx]] (coords are (y, x))
    double tr = syy + sxx;
    double dd = sqrt(fmax((syy - sxx) * (syy - sxx) + 4.0 * sxy * sxy,
                          0.0));
    double l_max = 0.5 * (tr + dd), l_min = 0.5 * (tr - dd);
    double vy, vx;  // major-axis eigenvector (dy, dx)
    if (fabs(sxy) > 1e-12) {
      vy = l_max - sxx;
      vx = sxy;
    } else if (syy >= sxx) {
      vy = 1.0; vx = 0.0;
    } else {
      vy = 0.0; vx = 1.0;
    }
    double vn = sqrt(vy * vy + vx * vx);
    vy /= vn; vx /= vn;

    double t0 = 1e300, t1 = -1e300;
    for (size_t r = 0; r < region.size(); ++r) {
      double dy = (region[r] / W) - cy_;
      double dx = (region[r] % W) - cx_;
      double t = dy * vy + dx * vx;
      if (t < t0) t0 = t;
      if (t > t1) t1 = t;
    }
    double length = t1 - t0;
    if (length < min_length) continue;
    double width = fmax(2.0 * sqrt(fmax(l_min, 1e-12)) * 2.0, 1.0);
    double density = (double)region.size() / (length * width);
    if (density < min_density) continue;

    double* s = seg_out + 4 * n_seg;
    s[0] = cx_ + t0 * vx;  // x1
    s[1] = cy_ + t0 * vy;  // y1
    s[2] = cx_ + t1 * vx;  // x2
    s[3] = cy_ + t1 * vy;  // y2
    grad_out[2 * n_seg] = gx;
    grad_out[2 * n_seg + 1] = gy;
    ++n_seg;
  }
  return n_seg;
}

}  // extern "C"
