// The port's copy of the JAX package's native/engine.cpp: the same code,
// byte for byte outside the comments, so the oracle's counters and dumps
// equal the JAX package's (tests/test_torch_native.py). The port's
// message-level engine (ops/step.py and ops/handlers.py of this package)
// has the semantics that the comments below give the JAX engine.
//
// Native (C++) coherence engine: deterministic cycle-lockstep oracle.
//
// Role in the framework (SURVEY §2 row C4/C6/C8): the reference's one
// native component is its C/OpenMP simulator; this is the TPU-framework's
// native runtime counterpart — a host-side engine with *identical
// observable semantics to the JAX vectorized engine* (same cycle model,
// same arbitration rules, same quirks), used for:
//   * differential fuzzing of the JAX/Pallas path on random workloads,
//   * fast host-side schedule search for the racy golden suites,
//   * a `--engine native` execution path in the CLI.
//
// Deliberately NOT the reference's architecture: no OpenMP threads, no
// locks, no spinning. One deterministic scheduler steps every node
// through (dequeue-one-message | issue-one-instruction) per cycle;
// deliveries are sorted by (arbitration rank, program order) — the same
// semantics the JAX engine implements with sort+scatter. All dimensions
// are runtime parameters; sharer sets are tiled uint32 words.
//
// Protocol behavior follows the reference's handler contract
// (assignment.c:190-618) including its quirks (latched instruction fill
// values, unconditional unblocks, asymmetric dedup, blind-index writes);
// see ops/handlers.py for the quirk catalogue with line citations.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <vector>

namespace {

enum CacheState : int32_t { kModified = 0, kExclusive = 1, kShared = 2,
                            kInvalid = 3 };
enum DirState : int32_t { kEM = 0, kS = 1, kU = 2 };
enum MsgType : int32_t {
  kReadRequest = 0, kWriteRequest = 1, kReplyRd = 2, kReplyWr = 3,
  kReplyId = 4, kInv = 5, kUpgrade = 6, kWritebackInv = 7,
  kWritebackInt = 8, kFlush = 9, kFlushInvack = 10, kEvictShared = 11,
  kEvictModified = 12, kNone = 13,
};
enum OpType : int32_t { kRead = 0, kWrite = 1, kNop = 2 };

using BitVec = std::vector<uint32_t>;

struct Message {
  int32_t type = kNone;
  int32_t sender = 0;
  int32_t addr = 0;
  int32_t value = 0;
  int32_t second = 0;
  int32_t dirstate = 0;
  BitVec bitvec;
};

struct Metrics {
  int64_t cycles = 0, instrs_retired = 0, read_hits = 0, write_hits = 0,
          read_misses = 0, write_misses = 0, upgrades = 0, msgs_dropped = 0,
          invalidations = 0, evictions = 0;
  int64_t msgs_processed[13] = {0};
};

class Engine {
 public:
  Engine(int32_t num_nodes, int32_t cache_size, int32_t mem_size,
         int32_t queue_capacity, int32_t max_instrs)
      : n_(num_nodes), c_(cache_size), m_(mem_size), q_(queue_capacity),
        t_(max_instrs), words_((num_nodes + 31) / 32) {
    block_bits_ = 1;
    while ((1 << block_bits_) < m_) block_bits_++;
    cache_addr_.assign(n_ * c_, invalid_address());
    cache_val_.assign(n_ * c_, 0);
    cache_state_.assign(n_ * c_, kInvalid);
    memory_.resize(n_ * m_);
    for (int32_t node = 0; node < n_; ++node)
      for (int32_t b = 0; b < m_; ++b)
        memory_[node * m_ + b] = (20 * node + b) & 0xFF;
    dir_state_.assign(n_ * m_, kU);
    dir_bitvec_.assign(n_ * m_ * words_, 0);
    instr_op_.assign(n_ * t_, kNop);
    instr_addr_.assign(n_ * t_, 0);
    instr_val_.assign(n_ * t_, 0);
    instr_count_.assign(n_, 0);
    instr_idx_.assign(n_, -1);
    cur_val_.assign(n_, 0);
    waiting_.assign(n_, 0);
    delay_.assign(n_, 0);
    period_.assign(n_, 1);
    arb_rank_.resize(n_);
    for (int32_t i = 0; i < n_; ++i) arb_rank_[i] = i;
    queues_.resize(n_);
  }

  int32_t invalid_address() const {
    // same sentinel rule as config.SystemConfig.invalid_address
    if (n_ <= 8 && c_ == 4 && m_ == 16 && t_ <= 32) return 0xFF;
    int32_t node_bits = 1;
    while ((1 << node_bits) < n_) node_bits++;
    return (1 << (block_bits_ + node_bits + 4)) - 1;
  }

  void load_trace(int32_t node, const int32_t* ops, const int32_t* addrs,
                  const int32_t* vals, int32_t count) {
    instr_count_[node] = count;
    for (int32_t i = 0; i < count && i < t_; ++i) {
      instr_op_[node * t_ + i] = ops[i];
      instr_addr_[node * t_ + i] = addrs[i];
      instr_val_[node * t_ + i] = vals[i] & 0xFF;
    }
  }

  void set_schedule(const int32_t* delays, const int32_t* periods) {
    if (delays) delay_.assign(delays, delays + n_);
    if (periods) period_.assign(periods, periods + n_);
  }

  void set_arbitration(const int32_t* rank) {
    if (rank) arb_rank_.assign(rank, rank + n_);
  }

  void set_admission(int32_t window) { admission_window_ = window; }

  // 0 = mailbox (reference-exact INV messages), 1 = scatter (home-side
  // invalidation, matching ops/handlers.py scatter mode: the home applies
  // the kill set itself at end of cycle; REPLY_ID carries no sharer set).
  void set_inv_mode(int32_t mode) { inv_mode_ = mode; }

  bool quiescent() const {
    for (int32_t i = 0; i < n_; ++i) {
      if (!queues_[i].empty() || waiting_[i]) return false;
      if (instr_idx_[i] < instr_count_[i] - 1) return false;
    }
    return true;
  }

  // Run until quiescent or max_cycles; returns cycles executed.
  int64_t run(int64_t max_cycles) {
    int64_t start = metrics_.cycles;
    while (!quiescent() && metrics_.cycles - start < max_cycles) cycle();
    return metrics_.cycles - start;
  }

  void cycle() {
    // Outgoing sends are buffered per cycle, then delivered in
    // (arb_rank(sender), program order) — identical to ops/mailbox.py.
    pending_.clear();
    pending_inv_.clear();
    // admission snapshot: outstanding requests at cycle start
    inflight_start_ = 0;
    for (uint8_t w : waiting_) inflight_start_ += w;
    admitted_this_cycle_ = 0;
    for (int32_t node = 0; node < n_; ++node) {
      if (!queues_[node].empty()) {
        Message msg = queues_[node].front();
        queues_[node].pop_front();
        metrics_.msgs_processed[msg.type]++;
        handle(node, msg);
      } else if (!waiting_[node]) {
        issue(node);
      }
    }
    deliver();
    apply_pending_inv();
    metrics_.cycles++;
  }

  // ---- state export -----------------------------------------------------
  void export_state(int32_t* cache_addr, int32_t* cache_val,
                    int32_t* cache_state, int32_t* memory,
                    int32_t* dir_state, uint32_t* dir_bitvec) const {
    std::memcpy(cache_addr, cache_addr_.data(),
                cache_addr_.size() * sizeof(int32_t));
    std::memcpy(cache_val, cache_val_.data(),
                cache_val_.size() * sizeof(int32_t));
    std::memcpy(cache_state, cache_state_.data(),
                cache_state_.size() * sizeof(int32_t));
    std::memcpy(memory, memory_.data(), memory_.size() * sizeof(int32_t));
    std::memcpy(dir_state, dir_state_.data(),
                dir_state_.size() * sizeof(int32_t));
    std::memcpy(dir_bitvec, dir_bitvec_.data(),
                dir_bitvec_.size() * sizeof(uint32_t));
  }

  void export_metrics(int64_t* out) const {
    int64_t vals[] = {metrics_.cycles, metrics_.instrs_retired,
                      metrics_.read_hits, metrics_.write_hits,
                      metrics_.read_misses, metrics_.write_misses,
                      metrics_.upgrades, metrics_.msgs_dropped,
                      metrics_.invalidations, metrics_.evictions};
    std::memcpy(out, vals, sizeof(vals));
  }

 private:
  // ---- address codec (codec.py equivalent) ------------------------------
  int32_t home_of(int32_t addr) const { return addr >> block_bits_; }
  int32_t block_of(int32_t addr) const {
    return addr & ((1 << block_bits_) - 1);
  }
  int32_t cline_of(int32_t addr) const { return block_of(addr) % c_; }

  // ---- bitvector helpers ------------------------------------------------
  BitVec bv_get(int32_t node, int32_t block) const {
    const uint32_t* p = &dir_bitvec_[(node * m_ + block) * words_];
    return BitVec(p, p + words_);
  }
  void bv_put(int32_t node, int32_t block, const BitVec& bv) {
    std::memcpy(&dir_bitvec_[(node * m_ + block) * words_], bv.data(),
                words_ * sizeof(uint32_t));
  }
  static bool bv_test(const BitVec& bv, int32_t bit) {
    return (bv[bit / 32] >> (bit % 32)) & 1;
  }
  static void bv_set(BitVec& bv, int32_t bit) {
    bv[bit / 32] |= (1u << (bit % 32));
  }
  static void bv_clear(BitVec& bv, int32_t bit) {
    bv[bit / 32] &= ~(1u << (bit % 32));
  }
  BitVec bv_single(int32_t bit) const {
    BitVec bv(words_, 0);
    bv_set(bv, bit);
    return bv;
  }
  static int32_t bv_popcount(const BitVec& bv) {
    int32_t total = 0;
    for (uint32_t w : bv) total += __builtin_popcount(w);
    return total;
  }
  static int32_t bv_lowest(const BitVec& bv) {
    for (size_t i = 0; i < bv.size(); ++i)
      if (bv[i]) return int32_t(i) * 32 + __builtin_ctz(bv[i]);
    return int32_t(bv.size()) * 32;
  }

  // ---- sends ------------------------------------------------------------
  void send(int32_t receiver, Message msg) {
    pending_.push_back({receiver, std::move(msg)});
  }

  void deliver() {
    // pending_ is already in per-sender program order; a stable sort by
    // arbitration rank of the sender yields the global enqueue order.
    std::vector<size_t> order(pending_.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
      return arb_rank_[pending_[a].second.sender] <
             arb_rank_[pending_[b].second.sender];
    });
    for (size_t i : order) {
      int32_t r = pending_[i].first;
      // Out-of-range receiver (e.g. owner lookup on an empty sharer set
      // returns the bit-width sentinel, state.py:ctz): the JAX engine's
      // delivery scatter drops these uncounted (mode="drop"); match it.
      if (r < 0 || r >= n_) continue;
      if (int32_t(queues_[r].size()) < q_) {
        queues_[r].push_back(std::move(pending_[i].second));
      } else {
        metrics_.msgs_dropped++;  // silent drop, reference overflow rule
      }
    }
  }

  // Scatter-mode invalidations are buffered during the handler loop and
  // applied against end-of-cycle state — the JAX engine computes the kill
  // mask on the post-update cache arrays (ops/step.py), and both engines
  // must see the same tags. The reference tracks no INV-acks
  // (assignment.c:358-361), so no reply traffic is owed.
  void apply_pending_inv() {
    for (const auto& p : pending_inv_) {
      const int32_t addr = p.first;
      const BitVec& bv = p.second;
      const int32_t line = cline_of(addr);
      for (int32_t t = 0; t < n_; ++t) {
        if (!bv_test(bv, t)) continue;
        if (ca(t, line) == addr) {
          if (cs(t, line) != kInvalid) metrics_.invalidations++;
          cs(t, line) = kInvalid;
        }
      }
    }
  }

  // ---- cache helpers ----------------------------------------------------
  int32_t& ca(int32_t node, int32_t line) { return cache_addr_[node*c_+line]; }
  int32_t& cv(int32_t node, int32_t line) { return cache_val_[node*c_+line]; }
  int32_t& cs(int32_t node, int32_t line) { return cache_state_[node*c_+line]; }

  // Eviction notice for a displaced line (handleCacheReplacement
  // contract: E/S -> EVICT_SHARED, M -> EVICT_MODIFIED with value,
  // INVALID -> nothing).
  void evict_notice(int32_t node, int32_t line) {
    int32_t st = cs(node, line);
    if (st == kInvalid) return;
    Message msg;
    msg.sender = node;
    msg.addr = ca(node, line);
    msg.bitvec.assign(words_, 0);
    if (st == kModified) {
      msg.type = kEvictModified;
      msg.value = cv(node, line);
    } else {
      msg.type = kEvictShared;
    }
    metrics_.evictions++;
    send(home_of(msg.addr), msg);
  }

  void fill(int32_t node, int32_t line, int32_t addr, int32_t value,
            int32_t state) {
    ca(node, line) = addr;
    cv(node, line) = value;
    cs(node, line) = state;
  }

  // ---- the 13 handlers --------------------------------------------------
  void handle(int32_t node, const Message& msg) {
    const int32_t home = home_of(msg.addr);
    const int32_t block = block_of(msg.addr);
    const int32_t line = cline_of(msg.addr);
    int32_t& dstate = dir_state_[node * m_ + block];
    int32_t& mem = memory_[node * m_ + block];
    Message out;
    out.bitvec.assign(words_, 0);

    switch (msg.type) {
      case kReadRequest: {  // at home
        BitVec bv = bv_get(node, block);
        if (dstate == kEM) {
          // forward to current owner; directory deferred until FLUSH
          out.type = kWritebackInt;
          out.sender = node;
          out.addr = msg.addr;
          out.second = msg.sender;
          send(bv_lowest(bv), out);
        } else {
          out.type = kReplyRd;
          out.sender = node;
          out.addr = msg.addr;
          out.value = mem;
          out.dirstate = (dstate == kS) ? kS : kEM;
          send(msg.sender, out);
          if (dstate == kS) {
            bv_set(bv, msg.sender);
          } else {
            dstate = kEM;
            bv = bv_single(msg.sender);
          }
          bv_put(node, block, bv);
        }
        break;
      }
      case kReplyRd: {  // at requester
        if (ca(node, line) != msg.addr && cs(node, line) != kInvalid)
          evict_notice(node, line);
        fill(node, line, msg.addr, msg.value,
             msg.dirstate == kS ? kShared : kExclusive);
        waiting_[node] = 0;
        break;
      }
      case kWritebackInt: {  // at old owner: flush to home (+requester)
        out.type = kFlush;
        out.sender = node;
        out.addr = msg.addr;
        out.value = cv(node, line);  // blind by index, like the C
        out.second = msg.second;
        send(home, out);
        if (home != msg.second) send(msg.second, out);  // dedup quirk
        cs(node, line) = kShared;
        break;
      }
      case kFlush: {
        if (node == home) {
          BitVec bv = bv_get(node, block);
          dstate = kS;
          bv_set(bv, msg.second);
          bv_put(node, block, bv);
          mem = msg.value;
        }
        if (node == msg.second) {
          if (ca(node, line) != msg.addr && cs(node, line) != kInvalid)
            evict_notice(node, line);
          fill(node, line, msg.addr, msg.value, kShared);
        }
        waiting_[node] = 0;  // unconditional (quirk 2)
        break;
      }
      case kUpgrade: {  // at home
        BitVec others = bv_get(node, block);
        bv_clear(others, msg.sender);
        out.type = kReplyId;
        out.sender = node;
        out.addr = msg.addr;
        if (inv_mode_ == 1) {
          pending_inv_.emplace_back(msg.addr, others);  // home-side kill
        } else {
          out.bitvec = others;
        }
        send(msg.sender, out);
        dstate = kEM;
        bv_put(node, block, bv_single(msg.sender));
        break;
      }
      case kReplyId: {  // at requester (new owner)
        // mailbox mode only — in scatter mode (1) the home already
        // applied the INVs when it processed the UPGRADE/WRITE_REQUEST
        if (inv_mode_ == 0) {
          for (int32_t i = 0; i < n_; ++i) {
            if (bv_test(msg.bitvec, i)) {
              Message inv;
              inv.type = kInv;
              inv.sender = node;
              inv.addr = msg.addr;
              inv.bitvec.assign(words_, 0);
              send(i, inv);
            }
          }
        }
        if (ca(node, line) != msg.addr && cs(node, line) != kInvalid)
          evict_notice(node, line);
        fill(node, line, msg.addr, cur_val_[node], kModified);  // quirk 1
        waiting_[node] = 0;
        break;
      }
      case kInv: {  // at sharer
        if (ca(node, line) == msg.addr) {
          if (cs(node, line) != kInvalid) metrics_.invalidations++;
          cs(node, line) = kInvalid;
        }
        break;
      }
      case kWriteRequest: {  // at home
        BitVec bv = bv_get(node, block);
        if (dstate == kU) {
          out.type = kReplyWr;
          out.sender = node;
          out.addr = msg.addr;
          send(msg.sender, out);
        } else if (dstate == kS) {
          BitVec others = bv;
          bv_clear(others, msg.sender);
          out.type = kReplyId;
          out.sender = node;
          out.addr = msg.addr;
          if (inv_mode_ == 1) {
            pending_inv_.emplace_back(msg.addr, others);  // home-side kill
          } else {
            out.bitvec = others;
          }
          send(msg.sender, out);
        } else {  // EM: ask old owner to flush+invalidate
          out.type = kWritebackInv;
          out.sender = node;
          out.addr = msg.addr;
          out.value = msg.value;
          out.second = msg.sender;
          send(bv_lowest(bv), out);
        }
        dstate = kEM;  // unconditional immediate update (quirk 4)
        bv_put(node, block, bv_single(msg.sender));
        break;
      }
      case kReplyWr: {  // at requester
        evict_notice(node, line);  // unconditional call, no tag check
        fill(node, line, msg.addr, cur_val_[node], kModified);
        waiting_[node] = 0;
        break;
      }
      case kWritebackInv: {  // at old owner
        out.type = kFlushInvack;
        out.sender = node;
        out.addr = msg.addr;
        out.value = cv(node, line);
        out.second = msg.second;
        send(home, out);
        send(msg.second, out);  // NO dedup (quirk 3)
        cs(node, line) = kInvalid;
        break;
      }
      case kFlushInvack: {
        if (node == home) {
          bv_put(node, block, bv_single(msg.second));
          mem = msg.value;
        }
        if (node == msg.second) {
          if (ca(node, line) != msg.addr && cs(node, line) != kInvalid)
            evict_notice(node, line);
          fill(node, line, msg.addr, cur_val_[node], kModified);
        }
        waiting_[node] = 0;  // unconditional (quirk 2)
        break;
      }
      case kEvictShared: {
        if (node != home) {
          cs(node, line) = kExclusive;  // blind promotion, no tag check
        } else {
          BitVec bv = bv_get(node, block);
          bv_clear(bv, msg.sender);
          bv_put(node, block, bv);
          int32_t sharers = bv_popcount(bv);
          if (sharers == 0) {
            dstate = kU;
          } else if (sharers == 1) {
            dstate = kEM;
            int32_t new_owner = bv_lowest(bv);
            if (new_owner != home) {
              out.type = kEvictShared;
              out.sender = node;
              out.addr = msg.addr;
              out.value = mem;
              send(new_owner, out);
            } else {
              cs(node, line) = kExclusive;  // inline self-promotion
            }
          }
        }
        break;
      }
      case kEvictModified: {  // at home
        mem = msg.value;
        bv_put(node, block, BitVec(words_, 0));
        dstate = kU;
        break;
      }
      default:
        break;
    }
  }

  // ---- instruction frontend --------------------------------------------
  void issue(int32_t node) {
    int64_t cyc = metrics_.cycles;
    if (cyc < delay_[node]) return;
    if ((cyc - delay_[node]) % std::max<int32_t>(period_[node], 1)) return;
    if (instr_idx_[node] >= instr_count_[node] - 1) return;
    int32_t i = instr_idx_[node] + 1;  // peek; commit only past admission
    int32_t op = instr_op_[node * t_ + i];
    int32_t addr = instr_addr_[node * t_ + i];
    int32_t val = instr_val_[node * t_ + i];
    int32_t home = home_of(addr);
    int32_t line = cline_of(addr);
    bool hit = ca(node, line) == addr && cs(node, line) != kInvalid;
    // admission control (backpressure; mirrors ops/frontend.py): an
    // instruction that would create an outstanding request retries next
    // cycle when the window is full.
    bool sends = (op == kRead && !hit) || (op == kWrite && !hit) ||
                 (op == kWrite && hit && cs(node, line) == kShared);
    if (sends && admission_window_ >= 0 &&
        inflight_start_ + admitted_this_cycle_ >= admission_window_) {
      return;
    }
    if (sends) admitted_this_cycle_++;
    instr_idx_[node] = i;
    cur_val_[node] = val;  // latch (quirk 1 source)
    // count at issue, like the JAX frontend's `issued` (every issued
    // instruction eventually completes; counting at unblock instead
    // double-counts under the premature-unblock quirk, SURVEY quirk 2)
    metrics_.instrs_retired++;
    if (op == kNop) {
      return;
    }
    Message msg;
    msg.sender = node;
    msg.addr = addr;
    msg.bitvec.assign(words_, 0);
    if (op == kRead) {
      if (hit) {
        metrics_.read_hits++;
      } else {
        metrics_.read_misses++;
        msg.type = kReadRequest;
        send(home, msg);
        waiting_[node] = 1;
      }
    } else {
      if (hit && (cs(node, line) == kModified ||
                  cs(node, line) == kExclusive)) {
        metrics_.write_hits++;
        cv(node, line) = val;
        cs(node, line) = kModified;
      } else if (hit) {  // SHARED write hit -> upgrade
        metrics_.write_hits++;
        metrics_.upgrades++;
        msg.type = kUpgrade;
        msg.value = val;
        send(home, msg);
        waiting_[node] = 1;
      } else {
        metrics_.write_misses++;
        msg.type = kWriteRequest;
        msg.value = val;
        send(home, msg);
        waiting_[node] = 1;
      }
    }
  }

  const int32_t n_, c_, m_, q_, t_, words_;
  int32_t block_bits_;
  std::vector<int32_t> cache_addr_, cache_val_, cache_state_;
  std::vector<int32_t> memory_, dir_state_;
  std::vector<uint32_t> dir_bitvec_;
  std::vector<int32_t> instr_op_, instr_addr_, instr_val_, instr_count_,
      instr_idx_, cur_val_, delay_, period_, arb_rank_;
  std::vector<uint8_t> waiting_;
  std::vector<std::deque<Message>> queues_;
  std::vector<std::pair<int32_t, Message>> pending_;
  std::vector<std::pair<int32_t, BitVec>> pending_inv_;  // (addr, targets)
  Metrics metrics_;
  int32_t inv_mode_ = 0;           // 0 = mailbox INV, 1 = home-side scatter
  int32_t admission_window_ = -1;  // -1 = no gating (reference semantics)
  int32_t inflight_start_ = 0;
  int32_t admitted_this_cycle_ = 0;
};

}  // namespace

extern "C" {

void* sim_create(int32_t num_nodes, int32_t cache_size, int32_t mem_size,
                 int32_t queue_capacity, int32_t max_instrs) {
  return new Engine(num_nodes, cache_size, mem_size, queue_capacity,
                    max_instrs);
}

void sim_destroy(void* h) { delete static_cast<Engine*>(h); }

void sim_load_trace(void* h, int32_t node, const int32_t* ops,
                    const int32_t* addrs, const int32_t* vals,
                    int32_t count) {
  static_cast<Engine*>(h)->load_trace(node, ops, addrs, vals, count);
}

void sim_set_schedule(void* h, const int32_t* delays,
                      const int32_t* periods) {
  static_cast<Engine*>(h)->set_schedule(delays, periods);
}

void sim_set_arbitration(void* h, const int32_t* rank) {
  static_cast<Engine*>(h)->set_arbitration(rank);
}

void sim_set_admission(void* h, int32_t window) {
  static_cast<Engine*>(h)->set_admission(window);
}

void sim_set_inv_mode(void* h, int32_t mode) {
  static_cast<Engine*>(h)->set_inv_mode(mode);
}

int64_t sim_run(void* h, int64_t max_cycles) {
  return static_cast<Engine*>(h)->run(max_cycles);
}

int32_t sim_quiescent(void* h) {
  return static_cast<Engine*>(h)->quiescent() ? 1 : 0;
}

void sim_export_state(void* h, int32_t* cache_addr, int32_t* cache_val,
                      int32_t* cache_state, int32_t* memory,
                      int32_t* dir_state, uint32_t* dir_bitvec) {
  static_cast<Engine*>(h)->export_state(cache_addr, cache_val, cache_state,
                                        memory, dir_state, dir_bitvec);
}

void sim_export_metrics(void* h, int64_t* out10) {
  static_cast<Engine*>(h)->export_metrics(out10);
}

}  // extern "C"
