// Native ingest / timestamp-association engine.
//
// C++ re-design of the reference's DataManager hot path: the callback
// queues (src/DataManager.h:204-211) + data_association_thread draining
// them into the time-indexed map with nearest-stamp matching at +-1 ms
// (src/DataManager.cpp:769-1091, range-search :924-928,1008-1013), and the
// >1 s input-gap detector that fires the kidnap reset path
// (src/DataManager.cpp:263-291).
//
// Differences by design: instead of eight ROS subscriber queues drained by
// a polling thread at 15 Hz, feeds are lock-striped ring buffers written by
// any thread; association happens in drain() (called by the single Python
// consumer), emitting frames in stamp order once they are older than a hold
// window (late pose/tracking messages still associate). Pixels stay on the
// Python side - this engine owns metadata association, which is the actual
// logic; it holds no GIL, so feeds from capture threads never block the
// TPU dispatch loop.
//
// Exposed as a plain C API for ctypes (no pybind11 in this toolchain).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

namespace {

struct Pose {
  double T[16];
};

struct Record {
  int64_t stamp_ns = 0;
  bool has_left = false;
  bool has_right = false;
  bool has_pose = false;
  bool has_tracking = false;
  bool is_keyframe = false;
  int32_t n_tracked = 0;
  Pose pose{};
};

struct Ctx {
  int64_t tol_ns;       // association tolerance (+-1 ms default)
  int64_t hold_ns;      // emit only frames older than newest - hold
  int64_t gap_ns;       // input-gap threshold (kidnap reset path)
  std::mutex mu;
  std::map<int64_t, Record> frames;     // keyed by image stamp
  std::multimap<int64_t, Pose> poses;   // unmatched pose buffer
  std::multimap<int64_t, std::pair<int32_t, bool>> tracking;  // (n, kf)
  int64_t newest_ns = 0;
  int64_t last_emitted_ns = 0;
  int64_t gap_count = 0;  // number of input gaps seen (bag-restart events)
  int64_t dropped = 0;    // overflow-dropped feeds
  size_t capacity;
};

// Nearest key within tol. Returns map.end() if none.
template <typename M>
typename M::iterator nearest(M& m, int64_t stamp, int64_t tol) {
  if (m.empty()) return m.end();
  auto it = m.lower_bound(stamp);
  typename M::iterator best = m.end();
  int64_t best_d = tol + 1;
  if (it != m.end()) {
    int64_t d = it->first - stamp;
    if (d < 0) d = -d;
    if (d <= tol && d < best_d) { best = it; best_d = d; }
  }
  if (it != m.begin()) {
    auto prev = std::prev(it);
    int64_t d = stamp - prev->first;
    if (d < 0) d = -d;
    if (d <= tol && d < best_d) { best = prev; best_d = d; }
  }
  return best;
}

void try_associate(Ctx* c, Record& r) {
  if (!r.has_pose) {
    auto it = nearest(c->poses, r.stamp_ns, c->tol_ns);
    if (it != c->poses.end()) {
      r.pose = it->second;
      r.has_pose = true;
      c->poses.erase(it);
    }
  }
  if (!r.has_tracking) {
    auto it = nearest(c->tracking, r.stamp_ns, c->tol_ns);
    if (it != c->tracking.end()) {
      r.n_tracked = it->second.first;
      r.is_keyframe = it->second.second;
      r.has_tracking = true;
      c->tracking.erase(it);
    }
  }
}

}  // namespace

extern "C" {

Ctx* ingest_create(double tol_s, double hold_s, double gap_s, int capacity) {
  auto* c = new Ctx();
  c->tol_ns = static_cast<int64_t>(tol_s * 1e9);
  c->hold_ns = static_cast<int64_t>(hold_s * 1e9);
  c->gap_ns = static_cast<int64_t>(gap_s * 1e9);
  c->capacity = static_cast<size_t>(capacity);
  return c;
}

void ingest_destroy(Ctx* c) { delete c; }

// Image arrival creates/extends the frame record (ref raw_image_callback +
// data_association_thread image drain, src/DataManager.cpp:790-847).
int ingest_push_image(Ctx* c, int64_t stamp_ns, int is_right) {
  std::lock_guard<std::mutex> lock(c->mu);
  if (c->frames.size() >= c->capacity) { c->dropped++; return -1; }
  if (c->newest_ns != 0 && stamp_ns - c->newest_ns > c->gap_ns) c->gap_count++;
  if (stamp_ns > c->newest_ns) c->newest_ns = stamp_ns;
  auto it = nearest(c->frames, stamp_ns, c->tol_ns);
  Record* r;
  if (it != c->frames.end()) {
    r = &it->second;
  } else {
    r = &c->frames[stamp_ns];
    r->stamp_ns = stamp_ns;
  }
  if (is_right) r->has_right = true; else r->has_left = true;
  try_associate(c, *r);
  return 0;
}

int ingest_push_pose(Ctx* c, int64_t stamp_ns, const double* T16) {
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = nearest(c->frames, stamp_ns, c->tol_ns);
  if (it != c->frames.end() && !it->second.has_pose) {
    std::memcpy(it->second.pose.T, T16, sizeof(double) * 16);
    it->second.has_pose = true;
    return 0;
  }
  if (c->poses.size() >= c->capacity) { c->dropped++; return -1; }
  Pose p;
  std::memcpy(p.T, T16, sizeof(double) * 16);
  c->poses.emplace(stamp_ns, p);
  return 0;
}

// Tracked-feature count + keyframe flag (ref ptcld_callback drain,
// src/DataManager.cpp:960-1049 setNumberOfSuccessfullyTrackedFeatures).
int ingest_push_tracking(Ctx* c, int64_t stamp_ns, int n_tracked, int is_keyframe) {
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = nearest(c->frames, stamp_ns, c->tol_ns);
  if (it != c->frames.end() && !it->second.has_tracking) {
    it->second.n_tracked = n_tracked;
    it->second.is_keyframe = is_keyframe != 0;
    it->second.has_tracking = true;
    return 0;
  }
  if (c->tracking.size() >= c->capacity) { c->dropped++; return -1; }
  c->tracking.emplace(stamp_ns, std::make_pair(n_tracked, is_keyframe != 0));
  return 0;
}

// Emit assembled frames older than (newest - hold), in stamp order.
// out layout per frame: stamp_ns (int64), T16 (doubles), n_tracked,
// flags bitmask: 1=left 2=right 4=pose 8=tracking 16=keyframe.
int ingest_drain(Ctx* c, int64_t* out_stamp, double* out_T, int32_t* out_n,
                 int32_t* out_flags, int max_out) {
  std::lock_guard<std::mutex> lock(c->mu);
  int n = 0;
  int64_t horizon = c->newest_ns - c->hold_ns;
  auto it = c->frames.begin();
  while (it != c->frames.end() && n < max_out && it->first <= horizon) {
    Record& r = it->second;
    try_associate(c, r);
    out_stamp[n] = r.stamp_ns;
    std::memcpy(out_T + 16 * n, r.pose.T, sizeof(double) * 16);
    out_n[n] = r.n_tracked;
    out_flags[n] = (r.has_left ? 1 : 0) | (r.has_right ? 2 : 0) |
                   (r.has_pose ? 4 : 0) | (r.has_tracking ? 8 : 0) |
                   (r.is_keyframe ? 16 : 0);
    it = c->frames.erase(it);
    if (out_stamp[n] > c->last_emitted_ns) c->last_emitted_ns = out_stamp[n];
    n++;
  }
  // prune stale unmatched pose/tracking entries (older than the horizon:
  // their frame will never arrive)
  while (!c->poses.empty() && c->poses.begin()->first < horizon - c->tol_ns)
    c->poses.erase(c->poses.begin());
  while (!c->tracking.empty() && c->tracking.begin()->first < horizon - c->tol_ns)
    c->tracking.erase(c->tracking.begin());
  return n;
}

int64_t ingest_gap_count(Ctx* c) {
  std::lock_guard<std::mutex> lock(c->mu);
  return c->gap_count;
}

int64_t ingest_pending(Ctx* c) {
  std::lock_guard<std::mutex> lock(c->mu);
  return static_cast<int64_t>(c->frames.size());
}

int64_t ingest_dropped(Ctx* c) {
  std::lock_guard<std::mutex> lock(c->mu);
  return c->dropped;
}

// Emit horizon: frames with stamp <= this have either been emitted or will
// be on the next drain; side-channel payloads (pixel buffers held by the
// Python layer) older than min(horizon, oldest_pending) are garbage.
int64_t ingest_emit_horizon(Ctx* c) {
  std::lock_guard<std::mutex> lock(c->mu);
  return c->newest_ns - c->hold_ns;
}

// Stamp of the oldest still-pending frame (INT64_MAX when empty): nothing
// below it will ever be emitted again.
int64_t ingest_oldest_pending(Ctx* c) {
  std::lock_guard<std::mutex> lock(c->mu);
  if (c->frames.empty()) return INT64_MAX;
  return c->frames.begin()->first;
}

}  // extern "C"
