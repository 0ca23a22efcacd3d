// Multi-threaded stress harness for the shm store, built to run under
// TSAN/ASAN (reference practice: the C++ store is CI-tested under
// sanitizers, SURVEY §5.2 / plasma's gtest+sanitizer runs).
//
// Threads hammer the full object lifecycle (create/seal/get/release/
// delete with eviction pressure) plus one SPSC channel pair, all
// against a single segment.  The process-shared robust mutexes are
// ordinary pthread mutexes within one process, so TSAN sees every
// lock/unlock edge the daemon/worker processes would take.
//
// Build+run (see run_sanitizers.sh):
//   g++ -O1 -g -fsanitize=thread  -pthread shmstore_stress.cc -o t && ./t
//   g++ -O1 -g -fsanitize=address -pthread shmstore_stress.cc -o a && ./a

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <unistd.h>

#include "shmstore.cc"  // single-TU build: sanitize the real code

namespace {

// ids use the store's padded width (shmstore.cc kIdLen = 24)
constexpr int kThreads = 4;
constexpr int kOpsPerThread = 3000;

void make_id(uint8_t* id, int thread_id, int n) {  // 24-byte padded id
  std::memset(id, 0, 24);
  id[0] = (uint8_t)thread_id;
  std::memcpy(id + 1, &n, sizeof(n));
}

std::atomic<int> failures{0};

void object_worker(void* h, int tid) {
  uint8_t id[24];
  for (int i = 0; i < kOpsPerThread; ++i) {
    make_id(id, tid, i);
    uint64_t off = 0;
    uint64_t size = 256 + (i % 7) * 1024;
    int rc = rts_create_ex(h, id, size, &off, /*allow_evict=*/1);
    if (rc != RTS_OK) continue;  // store full under pressure: fine
    rts_seal(h, id);
    uint64_t goff = 0, gsize = 0;
    if (rts_get(h, id, /*timeout_ms=*/0, &goff, &gsize) == RTS_OK) {
      if (gsize != size) failures.fetch_add(1);
      rts_release(h, id);
    }
    if (i % 3 == 0) rts_delete(h, id);
    if (i % 97 == 0) {
      uint8_t ids[32 * 24];
      rts_spill_candidates(h, ids, 32);
    }
  }
}

void chan_writer(void* h, const uint8_t* cid, int messages) {
  for (int i = 0; i < messages; ++i) {
    uint64_t off = 0, cap = 0;
    if (rts_chan_write_acquire(h, cid, 5000, &off, &cap) != RTS_OK) {
      failures.fetch_add(1);
      return;
    }
    std::memcpy((char*)((Handle*)h)->base + off, &i, sizeof(i));
    rts_chan_write_seal(h, cid, sizeof(i), /*kind=*/0);
  }
}

void chan_reader(void* h, const uint8_t* cid, int messages) {
  for (int i = 0; i < messages; ++i) {
    uint64_t off = 0, size = 0;
    uint32_t kind = 0;
    if (rts_chan_read_acquire(h, cid, 5000, &off, &size, &kind) != RTS_OK) {
      failures.fetch_add(1);
      return;
    }
    int got = -1;
    std::memcpy(&got, (char*)((Handle*)h)->base + off, sizeof(got));
    if (got != i) failures.fetch_add(1);
    rts_chan_read_release(h, cid);
  }
}

}  // namespace

int main() {
  // a segment of this process's own: passes from two checkouts, or the
  // JAX package's beside this one, may run at once
  char name[64];
  std::snprintf(name, sizeof(name), "/rtts_sanitizer_stress_%d",
                (int)getpid());
  rts_unlink(name);
  void* h = rts_create_store(name, /*capacity=*/8 << 20, /*table_cap=*/4096);
  if (!h) {
    std::fprintf(stderr, "create_store failed\n");
    return 2;
  }

  uint8_t cid[24];
  std::memset(cid, 0xCC, 24);
  if (rts_chan_create(h, cid, /*nslots=*/8, /*slot_size=*/4096) != RTS_OK) {
    std::fprintf(stderr, "chan_create failed\n");
    return 2;
  }

  std::vector<std::thread> ts;
  for (int t = 0; t < kThreads; ++t)
    ts.emplace_back(object_worker, h, t);
  constexpr int kMsgs = 5000;
  ts.emplace_back(chan_writer, h, cid, kMsgs);
  ts.emplace_back(chan_reader, h, cid, kMsgs);
  for (auto& t : ts) t.join();

  rts_close(h);
  rts_unlink(name);
  if (failures.load() != 0) {
    std::fprintf(stderr, "stress failures: %d\n", failures.load());
    return 1;
  }
  std::printf("shmstore stress OK (%d threads x %d ops + %d chan msgs)\n",
              kThreads, kOpsPerThread, kMsgs);
  return 0;
}
