// The threads of a CUDA warp, team or block for the host rehearsals
// (tests/inner_warp_host.cpp, inner_team_host.cpp, staged_tiles_host.cpp):
// each thread of the group runs as a coroutine (ucontext) in the calling OS
// thread, and a barrier is a switch to the next waiting lane. A barrier of
// 32 std::threads needs the operating system to schedule all 32 before it
// opens, which other processes' load turns into time slices of waiting;
// here a barrier costs two context switches a lane and depends on no other
// thread. The order of work between two barriers is the lanes' round-robin
// order, so a read of an entry that no barrier separates from its write is
// as much a fault as on the card, and the NaN-filled slots still show it.
#pragma once

#include <ucontext.h>

#include <cstdio>
#include <cstdlib>
#include <new>
#include <vector>

namespace host_lanes {

// A barrier of `count` lanes of the running group (generation counted, so
// it can be reused at once).
struct Barrier {
  explicit Barrier(int n) : count(n) {}
  int count, arrived = 0;
  unsigned gen = 0;
};

struct Group {
  ucontext_t sched;
  std::vector<ucontext_t> ctx;
  std::vector<char> done;
  void (*body)(void*, int) = nullptr;
  void* arg = nullptr;
  int cur = 0;
};

inline thread_local Group* g_group = nullptr;
// arrivals at barriers and lanes finished: a round of the scheduler that
// moves none is a deadlock (lanes waiting at barriers that never open)
inline thread_local unsigned long g_progress = 0;

// the running lane's index in its group
inline int lane() { return g_group->cur; }

inline void yield() { swapcontext(&g_group->ctx[g_group->cur], &g_group->sched); }

inline void wait(Barrier& b) {
  const unsigned gen = b.gen;
  ++g_progress;
  if (++b.arrived == b.count) {
    b.arrived = 0;
    ++b.gen;
    return;
  }
  while (b.gen == gen) yield();
}

inline void entry() {
  Group* g = g_group;
  const int i = g->cur;
  g->body(g->arg, i);
  g->done[i] = 1;
  ++g_progress;
}  // returns to the scheduler (uc_link)

constexpr size_t kStack = 256 << 10;

// the first n lane stacks of kStack bytes, kept and reused by the calling
// thread (never touched pages are never committed)
inline char* const* stacks(int n) {
  static thread_local std::vector<char*> pool;
  while ((int)pool.size() < n) {
    char* s = static_cast<char*>(std::malloc(kStack));
    if (!s) throw std::bad_alloc();
    pool.push_back(s);
  }
  return pool.data();
}

// Run fn(i) for i in [0, n) as n lanes of one group; returns when every lane
// has returned.
template <class F>
void run(int n, F fn) {
  char* const* stack = stacks(n);
  Group g;
  g.ctx.resize(n);
  g.done.assign(n, 0);
  g.arg = &fn;
  g.body = [](void* f, int i) { (*static_cast<F*>(f))(i); };
  Group* outer = g_group;
  g_group = &g;
  for (int i = 0; i < n; ++i) {
    getcontext(&g.ctx[i]);
    g.ctx[i].uc_stack.ss_sp = stack[i];
    g.ctx[i].uc_stack.ss_size = kStack;
    g.ctx[i].uc_link = &g.sched;
    makecontext(&g.ctx[i], entry, 0);
  }
  for (int alive = n; alive > 0;) {
    const unsigned long before = g_progress;
    for (int i = 0; i < n; ++i) {
      if (g.done[i]) continue;
      g.cur = i;
      swapcontext(&g.sched, &g.ctx[i]);
      if (g.done[i]) --alive;
    }
    if (alive > 0 && g_progress == before) {
      std::fprintf(stderr, "host_lanes: %d of %d lanes wait at barriers that never open\n",
                   alive, n);
      std::abort();
    }
  }
  g_group = outer;
}

}  // namespace host_lanes
