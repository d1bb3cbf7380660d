// t3fs USRBIO — shared-memory I/O rings between app processes and the t3fs
// daemon, zero-copy through a shared iov buffer.
//
// The port's copy of t3fs/native/usrbio.cpp, built with chunk_engine.cpp and
// aio_reader.cpp into one host library by t3fs_torch/ops/_build.py
// (host_library); bound by t3fs_torch/lib/usrbio.py.
//
// Reference analog: src/lib/api/hf3fs_usrbio.h:59-170 (iov/ior create,
// prep_io/submit_ios/wait_for_ios over SysV shm + semaphores) and the FUSE
// daemon's ring service (src/fuse/IoRing.h:49-214 sqe/cqe ring sections,
// IovTable shm registry).  Fresh design: POSIX shm + process-shared unnamed
// semaphores + a pshared mutex for multi-threaded producers; the daemon side
// (t3fs_torch/fuse/ring_worker.py) pops sqes with the GIL released and completes
// them through the asyncio storage path.
//
// Ring layout in one shm segment:
//   [RingHdr][Sqe x entries][Cqe x entries]
// sq: app produces (tail), daemon consumes (head);  cq: the reverse.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <semaphore.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kRingMagic = 0x74334952;  // "t3IR"

struct Sqe {
  uint64_t userdata;
  uint64_t ident;     // inode id (reg_fd resolves fd -> ident app-side)
  uint64_t iov_off;   // offset into the shared iov buffer
  uint64_t len;
  uint64_t file_off;
  uint32_t op;        // 0 = read, 1 = write
  uint32_t flags;
};

struct Cqe {
  uint64_t userdata;
  int64_t result;     // bytes moved, or <0
  uint32_t status;    // StatusCode (0 = OK)
  uint32_t pad;
};

struct RingHdr {
  uint32_t magic;
  uint32_t entries;           // power of two
  char iov_name[64];
  std::atomic<uint64_t> sq_head, sq_tail;
  std::atomic<uint64_t> cq_head, cq_tail;
  pthread_mutex_t sq_mu;      // pshared, guards multi-threaded producers
  pthread_mutex_t cq_mu;      // pshared, guards multi-worker completions
  sem_t sq_sem;               // pshared doorbell: >=1 post per submit burst
  sem_t cq_sem;               // pshared doorbell: >=1 post per cqe burst
};

struct Ring {
  RingHdr* hdr;
  Sqe* sqes;
  Cqe* cqes;
  size_t map_len;
  int owner;  // created (vs opened)
  char shm_name[128];
};

size_t ring_bytes(uint32_t entries) {
  return sizeof(RingHdr) + entries * (sizeof(Sqe) + sizeof(Cqe));
}

void* map_shm(const char* name, size_t len, bool create, int* err) {
  int flags = O_RDWR | (create ? O_CREAT | O_EXCL : 0);
  int fd = shm_open(name, flags, 0600);
  if (fd < 0 && create && errno == EEXIST) {
    shm_unlink(name);  // stale segment from a crashed owner
    fd = shm_open(name, flags, 0600);
  }
  if (fd < 0) { *err = errno; return nullptr; }
  if (create && ftruncate(fd, len) != 0) {
    *err = errno;
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* p = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) { *err = errno; return nullptr; }
  return p;
}

int sem_timedwait_ms(sem_t* s, int timeout_ms) {
  if (timeout_ms < 0) return sem_wait(s);
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) { ts.tv_sec++; ts.tv_nsec -= 1000000000L; }
  return sem_timedwait(s, &ts);
}

}  // namespace

extern "C" {

// ---- iov (shared data buffer; reference hf3fs_iovcreate/iovopen) ----

void* t3fs_iov_create(const char* name, uint64_t size) {
  char shm[128];
  snprintf(shm, sizeof shm, "/t3fs-iov-%s", name);
  int err = 0;
  return map_shm(shm, size, true, &err);
}

void* t3fs_iov_open(const char* name, uint64_t size) {
  char shm[128];
  snprintf(shm, sizeof shm, "/t3fs-iov-%s", name);
  int err = 0;
  return map_shm(shm, size, false, &err);
}

void t3fs_iov_destroy(const char* name, void* base, uint64_t size) {
  if (base) munmap(base, size);
  char shm[128];
  snprintf(shm, sizeof shm, "/t3fs-iov-%s", name);
  shm_unlink(shm);
}

// Real size of an existing iov segment (fstat), 0 if absent.  The daemon
// must map the app's actual size: guessing smaller breaks valid iov_off
// values, guessing larger SIGBUSes past the segment end.
uint64_t t3fs_iov_stat(const char* name) {
  char shm[128];
  snprintf(shm, sizeof shm, "/t3fs-iov-%s", name);
  int fd = shm_open(shm, O_RDONLY, 0600);
  if (fd < 0) return 0;
  struct stat st;
  uint64_t size = (fstat(fd, &st) == 0) ? (uint64_t)st.st_size : 0;
  close(fd);
  return size;
}

void t3fs_iov_unmap(void* base, uint64_t size) {
  if (base) munmap(base, size);
}

// ---- ior (submission/completion ring; reference hf3fs_iorcreate4) ----

void* t3fs_ior_create(const char* name, uint32_t entries,
                      const char* iov_name) {
  if (entries == 0 || (entries & (entries - 1))) return nullptr;
  char shm[128];
  snprintf(shm, sizeof shm, "/t3fs-ior-%s", name);
  int err = 0;
  size_t len = ring_bytes(entries);
  void* p = map_shm(shm, len, true, &err);
  if (!p) return nullptr;
  auto* r = new Ring;
  r->hdr = static_cast<RingHdr*>(p);
  r->sqes = reinterpret_cast<Sqe*>(r->hdr + 1);
  r->cqes = reinterpret_cast<Cqe*>(r->sqes + entries);
  r->map_len = len;
  r->owner = 1;
  snprintf(r->shm_name, sizeof r->shm_name, "%s", shm);

  RingHdr* h = r->hdr;
  // a fresh segment: zero the header bytes, atomics and all (through void*
  // so -Wall's class-memaccess check sees the raw-memory intent)
  memset(static_cast<void*>(h), 0, sizeof *h);
  h->entries = entries;
  snprintf(h->iov_name, sizeof h->iov_name, "%s", iov_name ? iov_name : "");
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutex_init(&h->sq_mu, &ma);
  pthread_mutex_init(&h->cq_mu, &ma);
  pthread_mutexattr_destroy(&ma);
  sem_init(&h->sq_sem, 1, 0);
  sem_init(&h->cq_sem, 1, 0);
  std::atomic_thread_fence(std::memory_order_release);
  h->magic = kRingMagic;
  return r;
}

void* t3fs_ior_open(const char* name) {
  char shm[128];
  snprintf(shm, sizeof shm, "/t3fs-ior-%s", name);
  int err = 0;
  void* p = map_shm(shm, sizeof(RingHdr), false, &err);
  if (!p) return nullptr;
  auto* h0 = static_cast<RingHdr*>(p);
  if (h0->magic != kRingMagic) { munmap(p, sizeof(RingHdr)); return nullptr; }
  uint32_t entries = h0->entries;
  munmap(p, sizeof(RingHdr));
  size_t len = ring_bytes(entries);
  p = map_shm(shm, len, false, &err);
  if (!p) return nullptr;
  auto* r = new Ring;
  r->hdr = static_cast<RingHdr*>(p);
  r->sqes = reinterpret_cast<Sqe*>(r->hdr + 1);
  r->cqes = reinterpret_cast<Cqe*>(r->sqes + entries);
  r->map_len = len;
  r->owner = 0;
  snprintf(r->shm_name, sizeof r->shm_name, "%s", shm);
  return r;
}

void t3fs_ior_destroy(void* ring) {
  auto* r = static_cast<Ring*>(ring);
  if (!r) return;
  if (r->owner) shm_unlink(r->shm_name);
  munmap(r->hdr, r->map_len);
  delete r;
}

const char* t3fs_ior_iov_name(void* ring) {
  return static_cast<Ring*>(ring)->hdr->iov_name;
}

uint32_t t3fs_ior_entries(void* ring) {
  return static_cast<Ring*>(ring)->hdr->entries;
}

// App side: enqueue one sqe (reference hf3fs_prep_io).  Returns slot index
// >= 0, or -1 if the ring is full.
int64_t t3fs_ior_prep(void* ring, uint32_t op, uint64_t ident,
                      uint64_t iov_off, uint64_t len, uint64_t file_off,
                      uint64_t userdata) {
  auto* r = static_cast<Ring*>(ring);
  RingHdr* h = r->hdr;
  pthread_mutex_lock(&h->sq_mu);
  uint64_t tail = h->sq_tail.load(std::memory_order_relaxed);
  if (tail - h->sq_head.load(std::memory_order_acquire) >= h->entries) {
    pthread_mutex_unlock(&h->sq_mu);
    return -1;
  }
  Sqe& s = r->sqes[tail & (h->entries - 1)];
  s = Sqe{userdata, ident, iov_off, len, file_off, op, 0};
  h->sq_tail.store(tail + 1, std::memory_order_release);
  pthread_mutex_unlock(&h->sq_mu);
  return static_cast<int64_t>(tail);
}

// App side: wake the daemon (reference hf3fs_submit_ios).  The semaphore is
// a DOORBELL, not a count: one post covers the whole burst (one futex wake
// per wave instead of one per sqe) — consumers drain by head/tail and pass
// the wakeup on (sem_post) when they leave sqes behind, so nothing strands
// behind an already-consumed doorbell.
void t3fs_ior_submit(void* ring, uint32_t n) {
  auto* r = static_cast<Ring*>(ring);
  if (n) sem_post(&r->hdr->sq_sem);
}

// Daemon side: block up to timeout for one sqe; returns 1 on success,
// 0 on timeout, -1 on error.  Drains by head/tail first (doorbell may
// already be consumed); hands the doorbell on when sqes remain.
int t3fs_ior_pop_sqe(void* ring, Sqe* out, int timeout_ms) {
  auto* r = static_cast<Ring*>(ring);
  RingHdr* h = r->hdr;
  for (;;) {
    uint64_t head = h->sq_head.load(std::memory_order_relaxed);
    if (head != h->sq_tail.load(std::memory_order_acquire)) {
      *out = r->sqes[head & (h->entries - 1)];
      h->sq_head.store(head + 1, std::memory_order_release);
      if (head + 1 != h->sq_tail.load(std::memory_order_acquire))
        sem_post(&h->sq_sem);  // baton: more sqes behind this one
      return 1;
    }
    if (sem_timedwait_ms(&h->sq_sem, timeout_ms) != 0)
      return errno == ETIMEDOUT ? 0 : -1;
    // doorbell consumed: loop back and drain whatever is visible (a stale
    // doorbell for sqes already taken just reads as an empty ring here)
  }
}

// Daemon side: batched pop — drain whatever is visible (no semaphore ops at
// all when sqes are already waiting), else ONE blocking wait for the next
// burst's doorbell.  One library call AND at most one futex op per
// submission burst instead of one per sqe.  Returns count (0 on timeout,
// -1 on error).
int64_t t3fs_ior_pop_sqes(void* ring, Sqe* out, uint32_t max_n,
                          int timeout_ms) {
  auto* r = static_cast<Ring*>(ring);
  RingHdr* h = r->hdr;
  for (;;) {
    uint32_t got = 0;
    while (got < max_n) {
      uint64_t head = h->sq_head.load(std::memory_order_relaxed);
      if (head == h->sq_tail.load(std::memory_order_acquire)) break;
      out[got++] = r->sqes[head & (h->entries - 1)];
      h->sq_head.store(head + 1, std::memory_order_release);
    }
    if (got) {
      // hit max_n with sqes still queued: pass the doorbell on so the
      // next pop (or another worker) wakes without a fresh submit
      if (h->sq_head.load(std::memory_order_relaxed) !=
          h->sq_tail.load(std::memory_order_acquire))
        sem_post(&h->sq_sem);
      return got;
    }
    if (sem_timedwait_ms(&h->sq_sem, timeout_ms) != 0)
      return errno == ETIMEDOUT ? 0 : -1;
  }
}

// Daemon side: push a completion (reference IoRing cqe write + sem signal).
// Returns 0, or -1 if the cq is full (app not draining).
int t3fs_ior_complete(void* ring, uint64_t userdata, int64_t result,
                      uint32_t status) {
  auto* r = static_cast<Ring*>(ring);
  RingHdr* h = r->hdr;
  pthread_mutex_lock(&h->cq_mu);
  uint64_t tail = h->cq_tail.load(std::memory_order_relaxed);
  if (tail - h->cq_head.load(std::memory_order_acquire) >= h->entries) {
    pthread_mutex_unlock(&h->cq_mu);
    return -1;
  }
  r->cqes[tail & (h->entries - 1)] = Cqe{userdata, result, status, 0};
  h->cq_tail.store(tail + 1, std::memory_order_release);
  pthread_mutex_unlock(&h->cq_mu);
  sem_post(&h->cq_sem);
  return 0;
}

// Daemon side: batched complete — one mutex acquisition, one library call,
// and ONE doorbell post for a whole wave of cqes (the app drains by
// head/tail, so it doesn't need a token per cqe).  Returns the number
// queued (== n unless the cq is full because the app stopped draining).
int64_t t3fs_ior_complete_many(void* ring, const Cqe* arr, uint32_t n) {
  auto* r = static_cast<Ring*>(ring);
  RingHdr* h = r->hdr;
  pthread_mutex_lock(&h->cq_mu);
  uint32_t put = 0;
  for (; put < n; put++) {
    uint64_t tail = h->cq_tail.load(std::memory_order_relaxed);
    if (tail - h->cq_head.load(std::memory_order_acquire) >= h->entries)
      break;
    r->cqes[tail & (h->entries - 1)] = arr[put];
    h->cq_tail.store(tail + 1, std::memory_order_release);
  }
  pthread_mutex_unlock(&h->cq_mu);
  if (put) sem_post(&h->cq_sem);
  return put;
}

// App side: wait for >= min_n completions (reference hf3fs_wait_for_ios);
// drains up to max_n into out.  Returns count (possibly 0 on timeout).
// Drain-first by head/tail: cqes already landed cost zero semaphore ops;
// the semaphore only breaks ties when the ring looks empty.  Hands the
// doorbell on when cqes remain past max_n (another waiter may need it).
int64_t t3fs_ior_wait(void* ring, Cqe* out, uint32_t max_n, uint32_t min_n,
                      int timeout_ms) {
  auto* r = static_cast<Ring*>(ring);
  RingHdr* h = r->hdr;
  uint32_t got = 0;
  for (;;) {
    while (got < max_n) {
      uint64_t head = h->cq_head.load(std::memory_order_relaxed);
      if (head == h->cq_tail.load(std::memory_order_acquire)) break;
      out[got++] = r->cqes[head & (h->entries - 1)];
      h->cq_head.store(head + 1, std::memory_order_release);
    }
    if (got >= min_n || got >= max_n) break;
    if (sem_timedwait_ms(&h->cq_sem, timeout_ms) != 0) break;
    // doorbell consumed (possibly stale): loop back and drain by head/tail
  }
  if (got && h->cq_head.load(std::memory_order_relaxed) !=
                 h->cq_tail.load(std::memory_order_acquire))
    sem_post(&h->cq_sem);  // baton for the cqes we left behind
  return got;
}

}  // extern "C"
