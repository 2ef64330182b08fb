// Router core: the gateway's hot-path scheduler state in C++.
//
// Native-parity component: the reference keeps its TPS-EMA scheduler in
// compiled code (Rust balancer/mod.rs — EMA types.rs:98-121, selection
// :1922-1985, leases/active counts :2273-2427). Here the same state machine
// — per-(endpoint, model, api_kind) EMA map, per-endpoint active counts,
// per-model round-robin counters, and the scoring/tie-break selection — is a
// C++ library driven from LoadManager via ctypes, with the pure-Python
// implementation as the always-available fallback. Selection semantics are
// bit-identical to balancer.py _select_locked (tested side by side):
//   score = +inf when unmeasured else ema * telemetry_penalty
//   top = argmax(score); ties -> max penalty; remaining ties -> round-robin.
//
// All calls lock one mutex; the gateway's request rate (micro-ops per
// request) is far below contention range, and a single lock keeps the
// cross-language state machine easy to reason about.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct TpsState {
  double ema = 0.0;
  int64_t samples = 0;
  double last_update = 0.0;
};

struct RouterCore {
  std::mutex mu;
  double alpha;
  std::unordered_map<std::string, TpsState> tps;  // eid \x1f model \x1f kind
  std::unordered_map<std::string, int64_t> active;     // endpoint id
  std::unordered_map<std::string, int64_t> rr;         // model
  int64_t total_requests = 0;

  explicit RouterCore(double a) : alpha(a) {}
};

std::string key3(const char* eid, const char* model, const char* kind) {
  std::string k(eid);
  k.push_back('\x1f');
  k += model;
  k.push_back('\x1f');
  k += kind;
  return k;
}

}  // namespace

// Implemented in hash_chain.cpp (same shared object): hex SHA-256 of a byte
// buffer. Reused for the rendezvous-hash owner below so the native and
// Python (hashlib) sides agree bit for bit.
extern "C" void sha256_hex(const char* data, int64_t len, char* out_hex);

extern "C" {

void* rc_new(double alpha) { return new RouterCore(alpha); }

void rc_free(void* h) { delete static_cast<RouterCore*>(h); }

void rc_update_tps(void* h, const char* eid, const char* model,
                   const char* kind, int64_t tokens, double duration_s,
                   double now) {
  if (duration_s <= 0 || tokens <= 0) return;
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  TpsState& st = rc->tps[key3(eid, model, kind)];
  const double tps = static_cast<double>(tokens) / duration_s;
  if (st.samples == 0) {
    st.ema = tps;
  } else {
    st.ema = rc->alpha * tps + (1.0 - rc->alpha) * st.ema;
  }
  st.samples += 1;
  st.last_update = now;
}

void rc_seed_tps(void* h, const char* eid, const char* model, const char* kind,
                 double ema, int64_t samples, double now) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  rc->tps[key3(eid, model, kind)] = TpsState{ema, samples, now};
}

// Returns the EMA, or -1.0 when the key is unmeasured (absent or 0 samples).
double rc_get_tps(void* h, const char* eid, const char* model,
                  const char* kind) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  auto it = rc->tps.find(key3(eid, model, kind));
  if (it == rc->tps.end() || it->second.samples == 0) return -1.0;
  return it->second.ema;
}

void rc_clear_endpoint(void* h, const char* eid) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  const std::string prefix = std::string(eid) + '\x1f';
  for (auto it = rc->tps.begin(); it != rc->tps.end();) {
    if (it->first.compare(0, prefix.size(), prefix) == 0) {
      it = rc->tps.erase(it);
    } else {
      ++it;
    }
  }
}

int64_t rc_tracked_keys(void* h) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  return static_cast<int64_t>(rc->tps.size());
}

// begin_request: unconditional lease acquire (+1 active, +1 total).
void rc_begin(void* h, const char* eid) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  rc->active[eid] += 1;
  rc->total_requests += 1;
}

void rc_release(void* h, const char* eid) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  int64_t& a = rc->active[eid];
  if (a > 0) a -= 1;
}

int64_t rc_active(void* h, const char* eid) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  auto it = rc->active.find(eid);
  return it == rc->active.end() ? 0 : it->second;
}

int64_t rc_total_active(void* h) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  int64_t total = 0;
  for (const auto& kv : rc->active) total += kv.second;
  return total;
}

int64_t rc_total_requests(void* h) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  return rc->total_requests;
}

// Selection over n candidates (parallel arrays of endpoint ids and
// telemetry penalties). Candidates at/over the active cap are excluded.
// Returns the index of the chosen candidate, or -1 when none qualify.
// When admit != 0 the chosen endpoint's lease is acquired atomically under
// the same lock (try_admit semantics — no select-then-begin race).
int64_t rc_select(void* h, const char* model, const char** eids,
                  const double* penalties, int64_t n, int64_t cap,
                  const char* kind, int admit) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);

  const double inf = std::numeric_limits<double>::infinity();
  std::vector<int64_t> idx;
  std::vector<double> score;
  idx.reserve(n);
  score.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    auto ait = rc->active.find(eids[i]);
    const int64_t a = ait == rc->active.end() ? 0 : ait->second;
    if (a >= cap) continue;
    auto tit = rc->tps.find(key3(eids[i], model, kind));
    const bool unmeasured = tit == rc->tps.end() || tit->second.samples == 0;
    idx.push_back(i);
    score.push_back(unmeasured ? inf : tit->second.ema * penalties[i]);
  }
  if (idx.empty()) return -1;

  const double best = *std::max_element(score.begin(), score.end());
  std::vector<int64_t> top;
  for (size_t j = 0; j < idx.size(); ++j) {
    if (score[j] == best) top.push_back(idx[j]);
  }
  if (top.size() > 1) {
    double best_pen = -inf;
    for (int64_t i : top) best_pen = std::max(best_pen, penalties[i]);
    std::vector<int64_t> filtered;
    for (int64_t i : top) {
      if (penalties[i] == best_pen) filtered.push_back(i);
    }
    top.swap(filtered);
  }
  int64_t& counter = rc->rr[model];
  const int64_t chosen = top[counter % static_cast<int64_t>(top.size())];
  counter += 1;
  if (admit) {
    rc->active[eids[chosen]] += 1;
    rc->total_requests += 1;
  }
  return chosen;
}

// (ema, samples, last_update) for one tracked key. Returns 1 when the key is
// measured, 0 otherwise. Feeds TPS gossip: the publisher ships the exact
// local state and the receiver compares last_update for last-writer-wins.
int32_t rc_tps_info(void* h, const char* eid, const char* model,
                    const char* kind, double* ema, int64_t* samples,
                    double* last_update) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  auto it = rc->tps.find(key3(eid, model, kind));
  if (it == rc->tps.end() || it->second.samples == 0) return 0;
  *ema = it->second.ema;
  *samples = it->second.samples;
  *last_update = it->second.last_update;
  return 1;
}

// Rendezvous (highest-random-weight) consistent-hash owner of `key` over n
// candidate ids: argmax over the first 8 bytes (big-endian) of
// sha256("key|id"), ties toward the lexicographically smallest id — the
// exact rule of balancer.hrw_owner, so every worker (and both languages)
// maps a prefix to the same endpoint with zero coordination. Returns the
// winning index, or -1 for an empty candidate list.
int64_t hrw_select(const char* key, const char** ids, int64_t n) {
  if (n <= 0) return -1;
  int64_t best = -1;
  uint64_t best_w = 0;
  std::string buf;
  char hex[65];
  for (int64_t i = 0; i < n; ++i) {
    buf.assign(key);
    buf.push_back('|');
    buf += ids[i];
    sha256_hex(buf.data(), static_cast<int64_t>(buf.size()), hex);
    uint64_t w = 0;
    for (int j = 0; j < 16; ++j) {
      const char c = hex[j];
      w = (w << 4) |
          static_cast<uint64_t>(c <= '9' ? c - '0' : c - 'a' + 10);
    }
    if (best < 0 || w > best_w ||
        (w == best_w && std::strcmp(ids[i], ids[best]) < 0)) {
      best = i;
      best_w = w;
    }
  }
  return best;
}

// Constant-time byte comparison for the auth hot path (API keys, JWT
// signatures): scans both buffers fully regardless of where they differ,
// so the comparison leaks length only (Python twin: hmac.compare_digest).
int32_t ct_equal(const uint8_t* a, int64_t alen, const uint8_t* b,
                 int64_t blen) {
  uint64_t acc = static_cast<uint64_t>(alen ^ blen);
  const int64_t n = alen < blen ? alen : blen;
  for (int64_t i = 0; i < n; ++i) acc |= static_cast<uint64_t>(a[i] ^ b[i]);
  // fold in trailing bytes of the longer buffer so timing does not depend
  // on the shorter prefix matching
  for (int64_t i = n; i < alen; ++i) acc |= static_cast<uint64_t>(a[i]) | 1;
  for (int64_t i = n; i < blen; ++i) acc |= static_cast<uint64_t>(b[i]) | 1;
  return acc == 0 ? 1 : 0;
}

// Snapshot of the TPS map as tab/newline-separated text:
//   eid \t model \t kind \t ema \t samples \t last_update \n
// Returns the number of bytes required; writes up to `cap` bytes into `buf`
// (call once with cap=0 to size, then again with a buffer).
int64_t rc_snapshot(void* h, char* buf, int64_t cap) {
  auto* rc = static_cast<RouterCore*>(h);
  std::lock_guard<std::mutex> g(rc->mu);
  std::string out;
  out.reserve(rc->tps.size() * 64);
  char line[256];
  for (const auto& kv : rc->tps) {
    std::string k = kv.first;
    std::replace(k.begin(), k.end(), '\x1f', '\t');
    std::snprintf(line, sizeof(line), "\t%.17g\t%lld\t%.17g\n", kv.second.ema,
                  static_cast<long long>(kv.second.samples),
                  kv.second.last_update);
    out += k;
    out += line;
  }
  const int64_t needed = static_cast<int64_t>(out.size());
  if (buf != nullptr && cap > 0) {
    std::memcpy(buf, out.data(), std::min<int64_t>(needed, cap));
  }
  return needed;
}

}  // extern "C"
