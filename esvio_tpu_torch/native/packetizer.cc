// Native event packetizer + measurement sync — the host-side data loader.
//
// C++ counterpart of the reference's ingestion plumbing (event buffering,
// L/R packet pairing, FREQ control, IMU interval slicing with boundary
// interpolation — stereo_event_tracker_node.cpp:372-419 sync_process,
// stereo_estimator_node.cpp:115-170 getMeasurements + :324-348 interpolation),
// re-designed as batch operations that fill fixed-capacity, mask-padded
// arrays ready for device upload (the pipeline consumes static shapes).
//
// Exposed through a plain C ABI for ctypes (esvio_tpu_torch/io/native.py),
// built by the host compiler at first use (esvio_tpu_torch/_kernels.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Slice a time-sorted event stream into fixed-capacity frame chunks at
// `freq` Hz starting from t0.  For each frame k (k = 1..n_frames), events in
// (edge[k-1], edge[k]] are packed newest-last; if the interval holds more
// than `capacity` events only the newest `capacity` are kept (matching the
// latest-only buffer semantics of the reference's event callbacks).
//
// Outputs (preallocated by caller):
//   out_t     [n_frames * capacity]  float32
//   out_x/y   [n_frames * capacity]  int32
//   out_p     [n_frames * capacity]  int32
//   out_valid [n_frames * capacity]  uint8
//   out_stamp [n_frames]             double   (frame timestamps)
// Returns the number of frames produced (<= n_frames).
int64_t esv_packetize(const double* t, const int32_t* x, const int32_t* y,
                      const int32_t* p, int64_t n_events, double t0,
                      double freq, int64_t capacity, int64_t n_frames,
                      float* out_t, int32_t* out_x, int32_t* out_y,
                      int32_t* out_p, uint8_t* out_valid, double* out_stamp) {
  if (n_events <= 0 || freq <= 0 || capacity <= 0) return 0;
  const double dt = 1.0 / freq;
  // start index: first event with t > t0
  const double* begin = std::upper_bound(t, t + n_events, t0);
  int64_t lo = begin - t;
  int64_t frame = 0;
  double edge = t0;
  while (frame < n_frames) {
    edge += dt;
    // find first index with t > edge
    const double* e = std::upper_bound(t + lo, t + n_events, edge);
    int64_t hi = e - t;
    if (hi == lo && hi >= n_events) break;
    int64_t start = lo;
    int64_t count = hi - lo;
    if (count > capacity) start = hi - capacity;  // keep newest
    int64_t m = hi - start;
    float* ot = out_t + frame * capacity;
    int32_t* ox = out_x + frame * capacity;
    int32_t* oy = out_y + frame * capacity;
    int32_t* op = out_p + frame * capacity;
    uint8_t* ov = out_valid + frame * capacity;
    for (int64_t i = 0; i < m; ++i) {
      ot[i] = static_cast<float>(t[start + i]);
      ox[i] = x[start + i];
      oy[i] = y[start + i];
      op[i] = p[start + i];
      ov[i] = 1;
    }
    std::memset(ov + m, 0, static_cast<size_t>(capacity - m));
    std::memset(ot + m, 0, sizeof(float) * static_cast<size_t>(capacity - m));
    std::memset(ox + m, 0, sizeof(int32_t) * static_cast<size_t>(capacity - m));
    std::memset(oy + m, 0, sizeof(int32_t) * static_cast<size_t>(capacity - m));
    std::memset(op + m, 0, sizeof(int32_t) * static_cast<size_t>(capacity - m));
    out_stamp[frame] = edge;
    ++frame;
    lo = hi;
    if (lo >= n_events) break;
  }
  return frame;
}

// IMU samples spanning (t0, t1] with boundary interpolation at t1
// (getMeasurements_event_image_imu semantics).  Returns count written
// (<= capacity); out arrays are [capacity] / [capacity*3].
int64_t esv_imu_between(const double* t, const double* acc, const double* gyr,
                        int64_t n, double t0, double t1, int64_t capacity,
                        double* out_t, double* out_acc, double* out_gyr) {
  const double* b = std::upper_bound(t, t + n, t0);
  const double* e = std::upper_bound(t, t + n, t1);
  int64_t i0 = b - t;
  int64_t i1 = e - t;
  int64_t k = 0;
  for (int64_t i = i0; i < i1 && k < capacity; ++i, ++k) {
    out_t[k] = t[i];
    for (int d = 0; d < 3; ++d) {
      out_acc[k * 3 + d] = acc[i * 3 + d];
      out_gyr[k * 3 + d] = gyr[i * 3 + d];
    }
  }
  // boundary interpolation at t1
  if (k < capacity && i1 < n && i1 > 0 && t[i1] > t1 && t[i1 - 1] < t1) {
    double w = (t1 - t[i1 - 1]) / (t[i1] - t[i1 - 1]);
    out_t[k] = t1;
    for (int d = 0; d < 3; ++d) {
      out_acc[k * 3 + d] = (1.0 - w) * acc[(i1 - 1) * 3 + d] + w * acc[i1 * 3 + d];
      out_gyr[k * 3 + d] = (1.0 - w) * gyr[(i1 - 1) * 3 + d] + w * gyr[i1 * 3 + d];
    }
    ++k;
  }
  return k;
}

// Merge two time-sorted event streams (e.g. re-chunking tool support —
// events_repacking_helper equivalent).  Outputs must hold n1+n2.
void esv_merge_streams(const double* t1, const int32_t* x1, const int32_t* y1,
                       const int32_t* p1, int64_t n1, const double* t2,
                       const int32_t* x2, const int32_t* y2, const int32_t* p2,
                       int64_t n2, double* ot, int32_t* ox, int32_t* oy,
                       int32_t* op, int32_t* osrc) {
  int64_t i = 0, j = 0, k = 0;
  while (i < n1 || j < n2) {
    bool take1 = j >= n2 || (i < n1 && t1[i] <= t2[j]);
    if (take1) {
      ot[k] = t1[i]; ox[k] = x1[i]; oy[k] = y1[i]; op[k] = p1[i]; osrc[k] = 0;
      ++i;
    } else {
      ot[k] = t2[j]; ox[k] = x2[j]; oy[k] = y2[j]; op[k] = p2[j]; osrc[k] = 1;
      ++j;
    }
    ++k;
  }
}

}  // extern "C"
