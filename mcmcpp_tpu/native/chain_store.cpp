// Native block chain store: the host-side runtime component of mcmcpp_tpu.
//
// accelerator-native re-design of the reference's chain storage layer
// (/root/reference/MCMCpp/Chain/Chain.h, Chain/ChainBlock.h): an append-only
// store of (step, walker, param) samples kept in 64-byte-aligned fixed-size
// blocks, byte-capped, with burn+thin compaction. Differences from the
// reference are deliberate:
//   - one arena per chain with separate logp planes (the sampler streams
//     device chunks here; there is no per-walker storeWalker path because
//     walkers are array rows, not objects),
//   - reads materialize into caller-provided buffers (NumPy arrays via
//     ctypes) instead of iterator objects,
//   - compaction allocates fresh blocks rather than sliding in place
//     (simpler, and the copy cost is identical).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr int64_t kAlign = 64;          // cacheline alignment (≙ Utility/Misc.h)
constexpr int64_t kBlockSteps = 10000;  // steps per block (≙ ChainBlock.h:31)

void* aligned_malloc(size_t bytes) {
  size_t padded = (bytes + kAlign - 1) / kAlign * kAlign;
  return std::aligned_alloc(kAlign, padded);
}

struct Block {
  char* pos = nullptr;   // [steps][W][P] * itemsize
  char* logp = nullptr;  // [steps][W] * itemsize
  int64_t used = 0;      // steps written

  ~Block() {
    std::free(pos);
    std::free(logp);
  }
};

struct ChainStore {
  int64_t n_walkers;
  int64_t n_params;
  int64_t max_bytes;
  int64_t itemsize;
  int64_t block_steps;
  std::vector<Block*> blocks;
  int64_t total_steps = 0;
  int64_t bytes = 0;

  int64_t row_bytes() const {
    return n_walkers * (n_params + 1) * itemsize;
  }
  int64_t pos_row_bytes() const { return n_walkers * n_params * itemsize; }
  int64_t logp_row_bytes() const { return n_walkers * itemsize; }

  ~ChainStore() {
    for (Block* b : blocks) delete b;
  }

  Block* tail_with_room() {
    if (!blocks.empty() && blocks.back()->used < block_steps)
      return blocks.back();
    Block* b = new (std::nothrow) Block();
    if (!b) return nullptr;
    b->pos = static_cast<char*>(aligned_malloc(block_steps * pos_row_bytes()));
    b->logp =
        static_cast<char*>(aligned_malloc(block_steps * logp_row_bytes()));
    if (!b->pos || !b->logp) {
      delete b;
      return nullptr;
    }
    blocks.push_back(b);
    return b;
  }

  // Append up to `steps`; returns how many were stored (capacity-limited,
  // ≙ IncrementStatus::EndOfChain when < steps).
  int64_t append(int64_t steps, const char* pos, const char* logp) {
    int64_t room = (max_bytes - bytes) / row_bytes();
    int64_t take = std::min(steps, std::max<int64_t>(room, 0));
    int64_t left = take;
    while (left > 0) {
      Block* b = tail_with_room();
      if (!b) break;
      int64_t n = std::min(left, block_steps - b->used);
      std::memcpy(b->pos + b->used * pos_row_bytes(), pos, n * pos_row_bytes());
      std::memcpy(b->logp + b->used * logp_row_bytes(), logp,
                  n * logp_row_bytes());
      b->used += n;
      pos += n * pos_row_bytes();
      logp += n * logp_row_bytes();
      total_steps += n;
      bytes += n * row_bytes();
      left -= n;
    }
    return take - left;
  }

  int64_t read_count(int64_t burn, int64_t thin) const {
    if (burn >= total_steps || thin < 1) return 0;
    return (total_steps - burn + thin - 1) / thin;
  }

  // Copy every thin-th step after burn into dst buffers (either may be null).
  void read(char* dst_pos, char* dst_logp, int64_t burn, int64_t thin) const {
    int64_t step = burn;
    int64_t bi = 0, base = 0;
    while (step < total_steps) {
      while (bi < (int64_t)blocks.size() && step >= base + blocks[bi]->used) {
        base += blocks[bi]->used;
        ++bi;
      }
      if (bi >= (int64_t)blocks.size()) break;
      const Block* b = blocks[bi];
      int64_t local = step - base;
      if (dst_pos) {
        std::memcpy(dst_pos, b->pos + local * pos_row_bytes(),
                    pos_row_bytes());
        dst_pos += pos_row_bytes();
      }
      if (dst_logp) {
        std::memcpy(dst_logp, b->logp + local * logp_row_bytes(),
                    logp_row_bytes());
        dst_logp += logp_row_bytes();
      }
      step += thin;
    }
  }

  void clear() {
    for (Block* b : blocks) delete b;
    blocks.clear();
    total_steps = 0;
    bytes = 0;
  }

  // Burn+thin compaction (≙ resetChainForSubSampling, Chain.h:269-305).
  void compact(int64_t burn, int64_t thin) {
    int64_t kept = read_count(burn, thin);
    std::vector<char> pos_buf(kept * pos_row_bytes());
    std::vector<char> logp_buf(kept * logp_row_bytes());
    read(pos_buf.data(), logp_buf.data(), burn, thin);
    clear();
    append(kept, pos_buf.data(), logp_buf.data());
  }
};

}  // namespace

extern "C" {

void* mc_chain_create(int64_t n_walkers, int64_t n_params, int64_t max_bytes,
                      int64_t itemsize) {
  if (n_walkers <= 0 || n_params <= 0 || itemsize <= 0) return nullptr;
  ChainStore* c = new (std::nothrow) ChainStore();
  if (!c) return nullptr;
  c->n_walkers = n_walkers;
  c->n_params = n_params;
  c->max_bytes = max_bytes;
  c->itemsize = itemsize;
  // keep blocks under ~64 MiB so tiny chains don't overallocate
  int64_t cap = (64LL << 20) / std::max<int64_t>(c->row_bytes(), 1);
  c->block_steps = std::max<int64_t>(1, std::min(kBlockSteps, cap));
  return c;
}

int64_t mc_chain_append(void* h, int64_t steps, const void* pos,
                        const void* logp) {
  return static_cast<ChainStore*>(h)->append(
      steps, static_cast<const char*>(pos), static_cast<const char*>(logp));
}

int64_t mc_chain_steps(void* h) {
  return static_cast<ChainStore*>(h)->total_steps;
}

int64_t mc_chain_bytes(void* h) { return static_cast<ChainStore*>(h)->bytes; }

int64_t mc_chain_read_count(void* h, int64_t burn, int64_t thin) {
  return static_cast<ChainStore*>(h)->read_count(burn, thin);
}

void mc_chain_read(void* h, void* dst_pos, void* dst_logp, int64_t burn,
                   int64_t thin) {
  static_cast<ChainStore*>(h)->read(static_cast<char*>(dst_pos),
                                    static_cast<char*>(dst_logp), burn, thin);
}

void mc_chain_compact(void* h, int64_t burn, int64_t thin) {
  static_cast<ChainStore*>(h)->compact(burn, thin);
}

void mc_chain_clear(void* h) { static_cast<ChainStore*>(h)->clear(); }

void mc_chain_destroy(void* h) { delete static_cast<ChainStore*>(h); }

}  // extern "C"
