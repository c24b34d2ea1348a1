// Native scenario generator: randomized roads + initial states + obstacles.
//
// Host-side data pipeline for the 10k-scenario suites (BASELINE.json config
// #5). Generating large scenario batches in Python/JAX steals host time from
// dispatching device work; this generator fills preallocated numpy buffers from
// a C++ thread pool so road generation overlaps with device execution.
//
// Layout contract (float32, C-order), matching mpc_tpu.sim.scenarios:
//   centerlines: [batch, size, 2]
//   y0:          [batch, 6]        (x, y, heading, vx, vy, omega)
//   obstacles:   [batch, n_obs, 4] (x, y, phi, v)
//
// Road families mirror sim/scenarios.py: straight (random heading/offset/
// spacing), arc (random radius/span/direction), quintic-Bezier lane change
// (reference geometry, bezier_curves.py:28-48, scaled to the 1:43 RC world).
//
// Deterministic per (seed, scenario index): each scenario derives its own
// splitmix-seeded mt19937_64, so results are independent of thread count.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

// splitmix64: decorrelate per-scenario seeds from a global seed.
uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97f4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct Rng {
  std::mt19937_64 gen;
  explicit Rng(uint64_t seed) : gen(seed) {}
  float uniform(float lo, float hi) {
    std::uniform_real_distribution<float> d(lo, hi);
    return d(gen);
  }
  int randint(int lo, int hi) {  // [lo, hi)
    std::uniform_int_distribution<int> d(lo, hi - 1);
    return d(gen);
  }
};

void make_straight(Rng& r, int size, float* cl) {
  float heading = r.uniform(-0.5f, 0.5f);
  float ox = r.uniform(-0.5f, 0.5f);
  float oy = r.uniform(-0.5f, 0.5f);
  float spacing = r.uniform(0.05f, 0.15f);
  float dx = std::cos(heading), dy = std::sin(heading);
  for (int i = 0; i < size; ++i) {
    cl[2 * i] = ox + spacing * i * dx;
    cl[2 * i + 1] = oy + spacing * i * dy;
  }
}

void make_arc(Rng& r, int size, float* cl) {
  float radius = r.uniform(2.0f, 8.0f);
  float span = r.uniform(1.5f, 2.0f * kPi);
  float sign = r.uniform(0.0f, 1.0f) < 0.5f ? -1.0f : 1.0f;
  for (int i = 0; i < size; ++i) {
    float theta = span * sign * static_cast<float>(i) / (size - 1);
    cl[2 * i] = radius * std::sin(theta);
    cl[2 * i + 1] = sign * radius * (1.0f - std::cos(theta));
  }
}

void make_lane_change(Rng& r, int size, float* cl) {
  // reference lane-change control points (bezier_curves.py:28-48)
  const float h = 3.75f, W = 1.8f, theta = 3.2f / 180.0f * kPi;
  const float l = 3.0f, Lf = 1.0f, v0 = 20.0f, v1 = 10.0f, D1 = 50.0f;
  float i_par = r.uniform(1.0f, 10.0f);
  float scale = r.uniform(0.005f, 0.02f);

  float Li = Lf + l;
  float Di = Li * std::cos(std::atan2(W, 2.0f * Lf) - theta);
  float tc1 = D1 / (v0 - v1);
  float Px2 = v0 * tc1 - Di;
  float Px5 = 2.0f * Px2;
  float Px1 = Px2 / i_par;
  float Px4 = Px5 - (Px5 - Px2) / i_par;

  float Px[6] = {0.0f, Px1, Px2, Px2, Px4, Px5};
  float Py[6] = {0.0f, 0.0f, 0.0f, h, h, h};
  const float binom[6] = {1, 5, 10, 10, 5, 1};

  for (int k = 0; k < size; ++k) {
    float t = static_cast<float>(k) / (size - 1);
    float x = 0.0f, y = 0.0f;
    for (int i = 0; i < 6; ++i) {
      float b = binom[i] * std::pow(1.0f - t, 5 - i) * std::pow(t, i);
      x += b * Px[i];
      y += b * Py[i];
    }
    cl[2 * k] = x * scale;
    cl[2 * k + 1] = y * scale;
  }
}

void one_scenario(uint64_t seed, int idx, int size, int n_obs,
                  float* cl, float* y0, float* obs) {
  Rng r(splitmix64(seed ^ (0x9E3779B97f4A7C15ull * (idx + 1))));
  int kind = r.randint(0, 3);
  switch (kind) {
    case 0: make_straight(r, size, cl); break;
    case 1: make_arc(r, size, cl); break;
    default: make_lane_change(r, size, cl); break;
  }

  // initial state near the road start, moving forward
  float d0x = cl[2] - cl[0], d0y = cl[3] - cl[1];
  float heading = std::atan2(d0y, d0x);
  float norm = std::sqrt(d0x * d0x + d0y * d0y);
  float nx = -d0y / norm, ny = d0x / norm;
  float lateral = r.uniform(-0.05f, 0.05f);
  y0[0] = cl[0] + nx * lateral;
  y0[1] = cl[1] + ny * lateral;
  y0[2] = heading + r.uniform(-0.2f, 0.2f);
  y0[3] = r.uniform(0.2f, 1.0f);
  y0[4] = 0.0f;
  y0[5] = 0.0f;

  // obstacles scattered along the road
  for (int k = 0; k < n_obs; ++k) {
    int oi = r.randint(size / 4, size - 1);
    obs[4 * k] = cl[2 * oi];
    obs[4 * k + 1] = cl[2 * oi + 1];
    obs[4 * k + 2] = 0.0f;
    obs[4 * k + 3] = r.uniform(0.0f, 0.5f);
  }
}

}  // namespace

extern "C" {

// Fill preallocated buffers with `batch` scenarios. Thread-count independent
// results. n_threads <= 0 means hardware concurrency.
void mpc_generate_scenarios(uint64_t seed, int batch, int size, int n_obs,
                            float* centerlines, float* y0, float* obstacles,
                            int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > batch) n_threads = batch;

  auto worker = [&](int t) {
    for (int i = t; i < batch; i += n_threads) {
      one_scenario(seed, i, size, n_obs,
                   centerlines + static_cast<size_t>(i) * size * 2,
                   y0 + static_cast<size_t>(i) * 6,
                   obstacles + static_cast<size_t>(i) * n_obs * 4);
    }
  };

  if (n_threads == 1) {
    worker(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
}

// Version tag for the python loader's cache invalidation.
int mpc_scenario_gen_abi_version() { return 1; }

}  // extern "C"
