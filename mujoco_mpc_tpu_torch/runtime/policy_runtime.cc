// Real-time policy runtime: lock-free double-buffered spline policy host.
//
// Native-runtime counterpart of the reference's AgentRunner C API
// (reference: mjpc/interface.cc:27-115 — background plan thread publishes a
// policy; a control thread samples actions at arbitrary times) and of the
// TimeSpline sampling semantics (mjpc/spline/spline.cc:103-156).
//
// Role in the PyTorch/CUDA package: the planner on the card publishes fresh
// spline parameters at plan rate (~10-100 Hz); a high-rate control thread
// (e.g. a 1 kHz robot servo loop) samples actions with zero allocation,
// zero locks on the read path, and no Python or torch in the loop. Writers
// use a double buffer: publish into the inactive slot, then atomically flip
// the active index.
//
// Built at first use by runtime.py (g++ -O2 -std=c++17 -fPIC -shared, into
// build/ at the repository root) and bound there with ctypes.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Interpolation : int32_t {
  kZero = 0,
  kLinear = 1,
  kCubic = 2,
};

struct PolicySlot {
  double t0 = 0.0;
  double dt = 1.0;
  std::vector<double> values;  // num_nodes * nu
};

struct Policy {
  int32_t nu = 0;
  int32_t num_nodes = 0;
  int32_t interp = kZero;
  std::vector<double> ctrl_lo, ctrl_hi;
  PolicySlot slots[2];
  std::atomic<int32_t> active{0};
  std::atomic<uint64_t> version{0};
};

double clampd(double x, double lo, double hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// finite-difference Hermite slope at node k (spline.cc:259-277 semantics)
double slope(const PolicySlot& s, int32_t num_nodes, int32_t nu, int32_t k,
             int32_t dim) {
  const double* v = s.values.data();
  const double inv_dt = 1.0 / s.dt;
  if (k == 0) {
    return (v[nu + dim] - v[dim]) * inv_dt;
  }
  if (k == num_nodes - 1) {
    return (v[k * nu + dim] - v[(k - 1) * nu + dim]) * inv_dt;
  }
  return 0.5 * (v[(k + 1) * nu + dim] - v[k * nu + dim]) * inv_dt +
         0.5 * (v[k * nu + dim] - v[(k - 1) * nu + dim]) * inv_dt;
}

}  // namespace

extern "C" {

void* mpc_policy_create(int32_t nu, int32_t num_nodes, int32_t interp) {
  auto* p = new Policy;
  p->nu = nu;
  p->num_nodes = num_nodes;
  p->interp = interp;
  p->ctrl_lo.assign(nu, -1e30);
  p->ctrl_hi.assign(nu, 1e30);
  for (auto& s : p->slots) {
    s.values.assign(static_cast<size_t>(num_nodes) * nu, 0.0);
  }
  return p;
}

void mpc_policy_destroy(void* handle) {
  delete static_cast<Policy*>(handle);
}

void mpc_policy_set_ctrlrange(void* handle, const double* lo,
                              const double* hi) {
  auto* p = static_cast<Policy*>(handle);
  std::memcpy(p->ctrl_lo.data(), lo, sizeof(double) * p->nu);
  std::memcpy(p->ctrl_hi.data(), hi, sizeof(double) * p->nu);
}

// Publish a new plan: write the inactive slot, flip the active index.
// Single-writer; readers never block.
void mpc_policy_update(void* handle, double t0, double dt,
                       const double* values) {
  auto* p = static_cast<Policy*>(handle);
  int32_t inactive = 1 - p->active.load(std::memory_order_relaxed);
  PolicySlot& s = p->slots[inactive];
  s.t0 = t0;
  s.dt = dt;
  std::memcpy(s.values.data(), values,
              sizeof(double) * p->num_nodes * p->nu);
  p->active.store(inactive, std::memory_order_release);
  p->version.fetch_add(1, std::memory_order_relaxed);
}

uint64_t mpc_policy_version(void* handle) {
  return static_cast<Policy*>(handle)->version.load(
      std::memory_order_relaxed);
}

// Sample the active policy at `time` (TimeSpline::Sample semantics:
// clamped ends, zero/linear/cubic-Hermite interpolation).
void mpc_policy_action(void* handle, double time, double* out) {
  auto* p = static_cast<Policy*>(handle);
  const PolicySlot& s =
      p->slots[p->active.load(std::memory_order_acquire)];
  const int32_t nn = p->num_nodes;
  const int32_t nu = p->nu;
  const double* v = s.values.data();

  double x = (time - s.t0) / s.dt;
  if (x < 0.0) x = 0.0;
  if (x > nn - 1) x = nn - 1;
  // zero-order hold may land on the LAST node (matches spline.py)
  int32_t lo_z = static_cast<int32_t>(std::floor(x));
  if (lo_z > nn - 1) lo_z = nn - 1;
  int32_t lo = lo_z;
  if (lo > nn - 2) lo = nn >= 2 ? nn - 2 : 0;
  double t = x - lo;
  int32_t hi = lo + 1 < nn ? lo + 1 : nn - 1;

  for (int32_t i = 0; i < nu; i++) {
    double value;
    switch (p->interp) {
      case kZero:
        value = v[lo_z * nu + i];
        break;
      case kLinear:
        value = v[lo * nu + i] * (1.0 - t) + v[hi * nu + i] * t;
        break;
      case kCubic:
      default: {
        const double p0 = v[lo * nu + i];
        const double p1 = v[hi * nu + i];
        const double m0 = slope(s, nn, nu, lo, i);
        const double m1 = slope(s, nn, nu, hi, i);
        const double c0 = 2 * t * t * t - 3 * t * t + 1;
        const double c1 = (t * t * t - 2 * t * t + t) * s.dt;
        const double c2 = -2 * t * t * t + 3 * t * t;
        const double c3 = (t * t * t - t * t) * s.dt;
        value = c0 * p0 + c1 * m0 + c2 * p1 + c3 * m1;
        break;
      }
    }
    out[i] = clampd(value, p->ctrl_lo[i], p->ctrl_hi[i]);
  }
}

}  // extern "C"
