// io_uring batch read engine for the storage read path.
//
// The port's copy of t3fs/native/aio_reader.cpp, behind
// t3fs_torch/storage/aio.py.
//
// Reference analog: src/storage/aio/ — AioReadWorker runs N threads each
// driving an io_uring/libaio completion loop (AioReadWorker.h:21-44,
// AioStatus.h:50-69 IoUringStatus wraps struct io_uring).  t3fs speaks
// the raw kernel interface (io_uring_setup/enter + mmap'd rings; this
// image has the kernel headers but not liburing) behind a small C ABI the
// Python storage service drives via ctypes: submitters queue preads into
// caller-owned buffers from any thread, one reaper thread blocks in
// io_uring_enter(GETEVENTS) and hands completions back.
//
// Memory model: SQ tail is published with a release store after the SQE
// is fully written; CQ head is consumed with acquire/release as the
// kernel requires (see io_uring.h ring documentation).

#include <linux/io_uring.h>

// std::max: GCC 13's <mutex> no longer brings in <algorithm>, so the
// reference's source, which leans on that, fails to build there
#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <mutex>

#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

int sys_io_uring_setup(unsigned entries, struct io_uring_params* p) {
  return static_cast<int>(syscall(__NR_io_uring_setup, entries, p));
}

int sys_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                       unsigned flags) {
  return static_cast<int>(syscall(__NR_io_uring_enter, fd, to_submit,
                                  min_complete, flags, nullptr, 0));
}

template <typename T>
T* ring_ptr(void* base, uint32_t off) {
  return reinterpret_cast<T*>(static_cast<uint8_t*>(base) + off);
}

struct Aio {
  int fd = -1;
  unsigned sq_entries = 0, cq_entries = 0;

  void* sq_ring = MAP_FAILED;
  size_t sq_ring_sz = 0;
  void* cq_ring = MAP_FAILED;   // == sq_ring with IORING_FEAT_SINGLE_MMAP
  size_t cq_ring_sz = 0;
  io_uring_sqe* sqes = static_cast<io_uring_sqe*>(MAP_FAILED);
  size_t sqes_sz = 0;
  bool single_mmap = false;

  // SQ pointers
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  // CQ pointers
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
  io_uring_cqe* cqes = nullptr;

  std::mutex mu;                 // submitter side: SQE alloc + tail
  unsigned queued = 0;           // prepped since last submit

  ~Aio() {
    if (sqes != MAP_FAILED) munmap(sqes, sqes_sz);
    if (!single_mmap && cq_ring != MAP_FAILED) munmap(cq_ring, cq_ring_sz);
    if (sq_ring != MAP_FAILED) munmap(sq_ring, sq_ring_sz);
    if (fd >= 0) close(fd);
  }
};

}  // namespace

extern "C" {

struct T3fsAioCqe {
  uint64_t user_data;
  int32_t res;        // bytes read, or -errno
  int32_t _pad;
};

void* t3fs_aio_create(unsigned entries) {
  io_uring_params p;
  memset(&p, 0, sizeof p);
  auto* a = new Aio();
  a->fd = sys_io_uring_setup(entries, &p);
  if (a->fd < 0) {
    delete a;
    return nullptr;
  }
  a->sq_entries = p.sq_entries;
  a->cq_entries = p.cq_entries;
  a->single_mmap = p.features & IORING_FEAT_SINGLE_MMAP;

  a->sq_ring_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
  a->cq_ring_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
  if (a->single_mmap)
    a->sq_ring_sz = a->cq_ring_sz = std::max(a->sq_ring_sz, a->cq_ring_sz);

  a->sq_ring = mmap(nullptr, a->sq_ring_sz, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, a->fd, IORING_OFF_SQ_RING);
  if (a->sq_ring == MAP_FAILED) { delete a; return nullptr; }
  a->cq_ring = a->single_mmap
      ? a->sq_ring
      : mmap(nullptr, a->cq_ring_sz, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, a->fd, IORING_OFF_CQ_RING);
  if (a->cq_ring == MAP_FAILED) { delete a; return nullptr; }

  a->sqes_sz = p.sq_entries * sizeof(io_uring_sqe);
  a->sqes = static_cast<io_uring_sqe*>(
      mmap(nullptr, a->sqes_sz, PROT_READ | PROT_WRITE,
           MAP_SHARED | MAP_POPULATE, a->fd, IORING_OFF_SQES));
  if (a->sqes == MAP_FAILED) { delete a; return nullptr; }

  a->sq_head = ring_ptr<unsigned>(a->sq_ring, p.sq_off.head);
  a->sq_tail = ring_ptr<unsigned>(a->sq_ring, p.sq_off.tail);
  a->sq_mask = ring_ptr<unsigned>(a->sq_ring, p.sq_off.ring_mask);
  a->sq_array = ring_ptr<unsigned>(a->sq_ring, p.sq_off.array);
  a->cq_head = ring_ptr<unsigned>(a->cq_ring, p.cq_off.head);
  a->cq_tail = ring_ptr<unsigned>(a->cq_ring, p.cq_off.tail);
  a->cq_mask = ring_ptr<unsigned>(a->cq_ring, p.cq_off.ring_mask);
  a->cqes = ring_ptr<io_uring_cqe>(a->cq_ring, p.cq_off.cqes);
  return a;
}

void t3fs_aio_destroy(void* h) {
  delete static_cast<Aio*>(h);
}

// Queue one pread(fd, buf, len, off); does NOT submit.  -EAGAIN if the
// SQ is full (caller should submit + retry).
int t3fs_aio_prep_read(void* h, int fd, uint64_t off, uint32_t len,
                       void* buf, uint64_t user_data) {
  auto* a = static_cast<Aio*>(h);
  std::lock_guard lk(a->mu);
  unsigned head = __atomic_load_n(a->sq_head, __ATOMIC_ACQUIRE);
  unsigned tail = *a->sq_tail;   // only submitters (under mu) write tail
  if (tail - head >= a->sq_entries) return -EAGAIN;
  unsigned idx = tail & *a->sq_mask;
  io_uring_sqe* sqe = &a->sqes[idx];
  memset(sqe, 0, sizeof *sqe);
  sqe->opcode = IORING_OP_READ;
  sqe->fd = fd;
  sqe->addr = reinterpret_cast<uint64_t>(buf);
  sqe->len = len;
  sqe->off = off;
  sqe->user_data = user_data;
  a->sq_array[idx] = idx;
  __atomic_store_n(a->sq_tail, tail + 1, __ATOMIC_RELEASE);
  a->queued++;
  return 0;
}

// NOP sqe: wakes a blocked waiter (shutdown / kick).
int t3fs_aio_prep_nop(void* h, uint64_t user_data) {
  auto* a = static_cast<Aio*>(h);
  std::lock_guard lk(a->mu);
  unsigned head = __atomic_load_n(a->sq_head, __ATOMIC_ACQUIRE);
  unsigned tail = *a->sq_tail;
  if (tail - head >= a->sq_entries) return -EAGAIN;
  unsigned idx = tail & *a->sq_mask;
  io_uring_sqe* sqe = &a->sqes[idx];
  memset(sqe, 0, sizeof *sqe);
  sqe->opcode = IORING_OP_NOP;
  sqe->user_data = user_data;
  a->sq_array[idx] = idx;
  __atomic_store_n(a->sq_tail, tail + 1, __ATOMIC_RELEASE);
  a->queued++;
  return 0;
}

// Submit everything queued; returns count consumed by the kernel or -errno.
// A published SQE is NEVER abandoned: on EINTR we retry, on partial accept
// we re-enter for the remainder, and on hard error the un-consumed count
// stays in `queued` so the next submit pushes it (the SQE ring slots are
// already written; dropping them would leave the kernel to later consume
// stale entries pointing at freed buffers).
int t3fs_aio_submit(void* h) {
  auto* a = static_cast<Aio*>(h);
  std::lock_guard lk(a->mu);
  int total = 0;
  while (a->queued > 0) {
    int r = sys_io_uring_enter(a->fd, a->queued, 0, 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    a->queued -= static_cast<unsigned>(r);
    total += r;
  }
  return total;
}

// Block until >= min_complete completions (0 = poll), drain up to max.
// Returns completions written to out[], or -errno.
int t3fs_aio_wait(void* h, unsigned min_complete, T3fsAioCqe* out,
                  unsigned max) {
  auto* a = static_cast<Aio*>(h);
  unsigned head = __atomic_load_n(a->cq_head, __ATOMIC_RELAXED);
  unsigned tail = __atomic_load_n(a->cq_tail, __ATOMIC_ACQUIRE);
  if (head == tail && min_complete > 0) {
    int r = sys_io_uring_enter(a->fd, 0, min_complete,
                               IORING_ENTER_GETEVENTS);
    if (r < 0 && errno != EINTR) return -errno;
    tail = __atomic_load_n(a->cq_tail, __ATOMIC_ACQUIRE);
  }
  unsigned n = 0;
  while (head != tail && n < max) {
    const io_uring_cqe& c = a->cqes[head & *a->cq_mask];
    out[n].user_data = c.user_data;
    out[n].res = c.res;
    out[n]._pad = 0;
    n++;
    head++;
  }
  __atomic_store_n(a->cq_head, head, __ATOMIC_RELEASE);
  return static_cast<int>(n);
}

}  // extern "C"
