// Reference-architecture liftover baseline: a single-threaded C++
// per-interval segment walk over the columnar arrays — the same
// algorithmic shape as the reference's halLiftover hot loop
// (/root/reference/liftover/impl/halBlockLiftover.cpp:46-113 driving
// api/impl/halSegmentMapper.cpp: binary search to the interval, then a
// per-segment walk up/down the genome path with paralogy-ring fan-out).
//
// The reference itself cannot be built in this environment (its HDF5 C++
// and sonLib dependencies have no headers here), so this provides the
// honest external anchor for BASELINE.md: what a reference-style native
// single-core implementation achieves on the SAME machine and data.  It
// is deliberately the straightforward pointer-walking design (per
// fragment, per level) — not the vectorized host mapper and not the device
// kernel — and its fragment count must equal the device path's exactly
// (checked by bench.py), so the measured ratio compares equal work.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct LevelT {
  const int64_t* starts;  // n+1
  int64_t n;
  const int64_t* link;
  const uint8_t* lrev;
  const int64_t* dst_starts;  // m+1 (child top starts for down levels)
  int64_t m;
  // down-level paralogy rings (null when absent)
  const int64_t* para;      // child top paralogy next-index
  const uint8_t* prev_flag; // child top parent-reversed flags
  bool up;
};

struct Frag {
  int64_t s_lo, s_hi, t_lo, t_hi;
  uint8_t rev;
};

struct Baseline {
  std::vector<LevelT> levels;
  std::vector<Frag> cur, nxt;
};

}  // namespace

extern "C" {

void* lb_new() { return new Baseline(); }

void lb_add_level(void* h, int64_t up, const int64_t* starts, int64_t n,
                  const int64_t* link, const uint8_t* lrev,
                  const int64_t* dst_starts, int64_t m, const int64_t* para,
                  const uint8_t* prev_flag) {
  Baseline* b = static_cast<Baseline*>(h);
  b->levels.push_back(LevelT{starts, n, link, lrev, dst_starts, m, para,
                             prev_flag, up != 0});
}

// Lift intervals [lo[i], hi[i]); returns total fragment count across the
// batch and (via checksum) the sum of all output coordinates, so callers
// can assert equality with the device path's output.
int64_t lb_run(void* h, const int64_t* lo, const int64_t* hi, int64_t n,
               int64_t* checksum) {
  Baseline* b = static_cast<Baseline*>(h);
  int64_t total = 0;
  int64_t sum = 0;
  for (int64_t q = 0; q < n; ++q) {
    b->cur.clear();
    if (hi[q] > lo[q]) b->cur.push_back({lo[q], hi[q], lo[q], hi[q], 0});
    for (const LevelT& lv : b->levels) {
      b->nxt.clear();
      for (const Frag& f : b->cur) {
        // binary search to the first overlapping segment, then walk right
        // (the reference's toSite + toRight scan)
        int64_t i = std::upper_bound(lv.starts, lv.starts + lv.n + 1,
                                     f.t_lo) -
                    lv.starts - 1;
        if (i < 0) i = 0;
        for (; i < lv.n && lv.starts[i] < f.t_hi; ++i) {
          int64_t p_lo = f.t_lo > lv.starts[i] ? f.t_lo : lv.starts[i];
          int64_t p_hi = f.t_hi < lv.starts[i + 1] ? f.t_hi : lv.starts[i + 1];
          if (p_hi <= p_lo) continue;
          int64_t li = lv.link[i];
          if (li < 0) continue;
          int64_t len = p_hi - p_lo;
          int64_t adv = f.rev ? f.t_hi - p_hi : p_lo - f.t_lo;
          int64_t s_lo = f.s_lo + adv;
          bool lrev = lv.lrev[i] != 0;
          int64_t off = p_lo - lv.starts[i];
          int64_t mirrored = lv.starts[i + 1] - p_hi;
          int64_t new_lo = lv.dst_starts[li] + (lrev ? mirrored : off);
          uint8_t nrev = f.rev ^ (lrev ? 1 : 0);
          b->nxt.push_back({s_lo, s_lo + len, new_lo, new_lo + len, nrev});
          if (!lv.up && lv.para != nullptr && lv.para[li] >= 0) {
            // paralogy-ring fan-out (mapSelf, halSegmentMapper.cpp:263)
            int64_t offm = new_lo - lv.dst_starts[li];
            int64_t j = lv.para[li];
            while (j != li && j >= 0) {
              bool flip = (lv.prev_flag[j] != 0) != (lv.prev_flag[li] != 0);
              int64_t mlo = flip
                                ? lv.dst_starts[j + 1] - offm - len
                                : lv.dst_starts[j] + offm;
              b->nxt.push_back({s_lo, s_lo + len, mlo, mlo + len,
                                static_cast<uint8_t>(nrev ^ (flip ? 1 : 0))});
              j = lv.para[j];
            }
          }
        }
      }
      std::swap(b->cur, b->nxt);
    }
    total += static_cast<int64_t>(b->cur.size());
    for (const Frag& f : b->cur) sum += f.s_lo + f.t_lo + f.t_hi + f.rev;
  }
  if (checksum) *checksum = sum;
  return total;
}

void lb_free(void* h) { delete static_cast<Baseline*>(h); }

}  // extern "C"
