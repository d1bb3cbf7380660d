// Native socket transport for the RPC data plane.
//
// The port's copy of t3fs/native/net_pump.cpp, behind
// t3fs_torch/net/native_conn.py, built with chunk_engine.cpp (whose
// t3fs_crc32c it calls) into one host library by t3fs_torch/ops/_build.py.
//
// Reference analog: src/common/net/ib/IBSocket.h:81-180 — the reference's
// bulk plane batches work-requests onto the NIC instead of paying a
// syscall per message.  On a TCP fabric the analogous win is moving the
// per-frame syscalls and frame assembly out of the Python event loop:
// one io_uring drives RECV/SEND for every connection in the process, a
// single pump thread parses t3f2 frames (header + CRC32C verification in
// C++), and Python is woken once per BATCH of completed frames through
// an eventfd.  The asyncio transport path stays the default; this pump
// is opt-in per process (T3FS_NATIVE_NET=1, see net/native_conn.py).
//
// Threading model:
//   - Python threads call t3fs_pump_add/send/close under Pump::mu; they
//     prep SQEs and submit directly (io_uring_enter is thread-safe).
//   - ONE pump thread blocks in io_uring_enter(GETEVENTS), processes
//     CQEs under mu, re-arms RECV/SEND, parses frames, and signals the
//     eventfd when the out-queue goes non-empty.
//   - Python's asyncio loop add_reader()s the eventfd and drains
//     t3fs_pump_poll (ownership of each frame buffer transfers; free
//     with t3fs_pump_free).
//
// Frame format (must match net/wire.py): 24-byte header
//   <IIIIII  magic msg_len payload_len flags msg_crc header_crc
// header_crc = crc32c(first 20 bytes); msg_crc = crc32c(msg bytes as on
// the wire).  Both are verified HERE, so the Python side skips its
// per-frame CRC pass entirely.

#include <linux/io_uring.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include <sys/eventfd.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/syscall.h>
#include <unistd.h>

extern "C" uint32_t t3fs_crc32c(const uint8_t* p, uint64_t n, uint32_t crc);

namespace {

constexpr uint32_t kMagic = 0x74336632;      // "t3f2" (wire.py MAGIC)
constexpr uint32_t kHeaderSize = 24;
constexpr uint64_t kMaxFrame = 512ull << 20; // wire.py MAX_FRAME
constexpr size_t kRecvBuf = 256 << 10;
// RX flow control: once this many undrained frame bytes sit in the out
// queue, RECVs stop re-arming (the kernel buffer fills, TCP closes the
// window — the role asyncio's StreamReader limit plays) until Python's
// poll drains below it.
constexpr size_t kRxHighWater = 64ull << 20;

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

// user_data encoding: (conn_id << 2) | op
enum Op : uint64_t { OP_NOP = 0, OP_RECV = 1, OP_SEND = 2 };

struct Frame {
  uint32_t conn_id;
  uint32_t flags;
  uint32_t msg_len;
  uint32_t payload_len;
  uint8_t* data;        // msg bytes then payload bytes; Python frees
};

// One queued outbound frame.  The header+msg half is owned (small; the
// staging copy is confined to it); the payload half is a BORROWED span
// pinned on the Python side until the pump emits this entry's release
// event (token) — the zero-copy bulk plane (the
// RDMABuf send-from-registered-buffer analog).  Legacy whole-frame sends
// put everything in hdr with token 0.
struct TxEntry {
  std::vector<uint8_t> hdr;
  const uint8_t* pay = nullptr;
  size_t pay_len = 0;
  uint64_t token = 0;           // != 0: Python holds a pin to drop
  size_t size() const { return hdr.size() + pay_len; }
};

struct Conn {
  int fd = -1;
  uint32_t id = 0;
  bool dead = false;
  bool recv_armed = false;
  bool send_armed = false;
  bool closed_reported = false;
  std::vector<uint8_t> rbuf;     // in-flight recv target
  std::vector<uint8_t> stage;    // unparsed stream bytes
  size_t stage_off = 0;          // consumed prefix of stage
  std::deque<TxEntry> txq;
  size_t tx_off = 0;             // sent prefix of txq.front()
  size_t tx_bytes = 0;           // total queued bytes (backpressure)
};

struct Pump {
  // ring
  int ring_fd = -1;
  unsigned sq_entries = 0;
  void* sq_ring = MAP_FAILED;
  size_t sq_ring_sz = 0;
  void* cq_ring = MAP_FAILED;
  size_t cq_ring_sz = 0;
  io_uring_sqe* sqes = static_cast<io_uring_sqe*>(MAP_FAILED);
  size_t sqes_sz = 0;
  bool single_mmap = false;
  unsigned *sq_head = nullptr, *sq_tail = nullptr, *sq_mask = nullptr,
           *sq_array = nullptr;
  unsigned *cq_head = nullptr, *cq_tail = nullptr, *cq_mask = nullptr;
  io_uring_cqe* cqes = nullptr;

  int efd = -1;
  std::thread th;
  std::mutex mu;
  std::atomic<bool> stopping{false};
  uint32_t next_id = 1;
  unsigned queued = 0;  // prepped, unsubmitted SQEs (under mu)
  std::unordered_map<uint32_t, std::unique_ptr<Conn>> conns;
  std::deque<Frame> out;          // completed frames for Python
  size_t out_bytes = 0;           // undrained frame bytes (RX flow ctl)
  std::deque<uint32_t> closed;    // dead conns to report
  // tx-release notifications: (conn_id, token) pairs whose borrowed
  // payload the kernel can no longer touch — Python drops the pin
  std::deque<std::pair<uint32_t, uint64_t>> released;
  // RX frame-buffer pool: power-of-two size classes (12..20 -> 4K..1M),
  // bounded per class — the registered-buffer-pool analog; buffers
  // cycle pump -> Python (memoryview, zero-copy) -> back via
  // t3fs_pump_free2 instead of malloc churn per frame
  static constexpr int kPoolMin = 12, kPoolMax = 20, kPoolCap = 32;
  std::deque<uint8_t*> pool[kPoolMax - kPoolMin + 1];
  // copy accounting (observability + the zero-copy regression tests):
  // staged = bytes memcpy'd into pump-owned memory, zc = borrowed bytes
  uint64_t tx_staged_bytes = 0, tx_zc_bytes = 0;
  uint64_t rx_frames = 0, rx_bytes = 0;

  static int pool_class(size_t n) {
    for (int c = kPoolMin; c <= kPoolMax; c++)
      if (n <= (1ull << c)) return c;
    return -1;
  }

  uint8_t* buf_alloc(size_t n) {
    int c = pool_class(n);
    if (c >= 0 && !pool[c - kPoolMin].empty()) {
      uint8_t* b = pool[c - kPoolMin].front();
      pool[c - kPoolMin].pop_front();
      return b;
    }
    return new uint8_t[c >= 0 ? (1ull << c) : n];
  }

  void buf_free(uint8_t* b, size_t n) {
    int c = pool_class(n);
    if (c >= 0 && pool[c - kPoolMin].size() < kPoolCap) {
      pool[c - kPoolMin].push_back(b);
      return;
    }
    delete[] b;
  }

  ~Pump() {
    if (sqes != MAP_FAILED) munmap(sqes, sqes_sz);
    if (!single_mmap && cq_ring != MAP_FAILED) munmap(cq_ring, cq_ring_sz);
    if (sq_ring != MAP_FAILED) munmap(sq_ring, sq_ring_sz);
    if (ring_fd >= 0) close(ring_fd);
    if (efd >= 0) close(efd);
    for (auto& f : out) delete[] f.data;
    for (auto& q : pool)
      for (uint8_t* b : q) delete[] b;
  }
};

// --- SQE helpers (caller holds mu) ---

io_uring_sqe* sqe_alloc(Pump* p) {
  unsigned head = __atomic_load_n(p->sq_head, __ATOMIC_ACQUIRE);
  unsigned tail = *p->sq_tail;
  if (tail - head >= p->sq_entries) return nullptr;
  unsigned idx = tail & *p->sq_mask;
  io_uring_sqe* sqe = &p->sqes[idx];
  memset(sqe, 0, sizeof *sqe);
  p->sq_array[idx] = idx;
  __atomic_store_n(p->sq_tail, tail + 1, __ATOMIC_RELEASE);
  p->queued++;
  return sqe;
}

// Submit everything queued (caller holds mu); published SQEs are never
// abandoned (same contract as aio_reader.cpp).
int submit_locked(Pump* p) {
  int total = 0;
  while (p->queued > 0) {
    int r = sys_io_uring_enter(p->ring_fd, p->queued, 0, 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    p->queued -= static_cast<unsigned>(r);
    total += r;
  }
  return total;
}

bool arm_recv(Pump* p, Conn* c) {
  if (c->dead || c->recv_armed) return true;
  if (p->out_bytes >= kRxHighWater) return true;  // paused; poll resumes
  io_uring_sqe* sqe = sqe_alloc(p);
  if (sqe == nullptr) return false;
  c->rbuf.resize(kRecvBuf);
  sqe->opcode = IORING_OP_RECV;
  sqe->fd = c->fd;
  sqe->addr = reinterpret_cast<uint64_t>(c->rbuf.data());
  sqe->len = kRecvBuf;
  sqe->user_data = (static_cast<uint64_t>(c->id) << 2) | OP_RECV;
  c->recv_armed = true;
  return true;
}

void wake_python(Pump* p);

bool arm_send(Pump* p, Conn* c) {
  if (c->dead || c->send_armed || c->txq.empty()) return true;
  io_uring_sqe* sqe = sqe_alloc(p);
  if (sqe == nullptr) return false;
  const TxEntry& e = c->txq.front();
  const uint8_t* base;
  size_t len;
  if (c->tx_off < e.hdr.size()) {        // header+msg segment (owned)
    base = e.hdr.data() + c->tx_off;
    len = e.hdr.size() - c->tx_off;
  } else {                               // payload segment (borrowed)
    size_t off = c->tx_off - e.hdr.size();
    base = e.pay + off;
    len = e.pay_len - off;
  }
  sqe->opcode = IORING_OP_SEND;
  sqe->fd = c->fd;
  sqe->addr = reinterpret_cast<uint64_t>(base);
  sqe->len = static_cast<uint32_t>(len);
  sqe->msg_flags = MSG_NOSIGNAL;
  sqe->user_data = (static_cast<uint64_t>(c->id) << 2) | OP_SEND;
  c->send_armed = true;
  return true;
}

// Retire the front tx entry; its borrowed payload (if any) is now out of
// the kernel's reach, so tell Python to drop the pin (caller holds mu).
void finish_tx_front(Pump* p, Conn* c) {
  TxEntry& e = c->txq.front();
  if (e.token != 0) {
    p->released.emplace_back(c->id, e.token);
    wake_python(p);
  }
  c->txq.pop_front();
  c->tx_off = 0;
}

// Drop every queued tx entry of a conn being destroyed, releasing the
// Python-side pins.  ONLY safe when no SEND SQE is armed — a published
// SQE still references the borrowed payload (caller holds mu).
void release_txq(Pump* p, Conn* c) {
  bool any = false;
  for (auto& e : c->txq) {
    if (e.token != 0) {
      p->released.emplace_back(c->id, e.token);
      any = true;
    }
  }
  c->txq.clear();
  c->tx_bytes = 0;
  if (any) wake_python(p);
}

void wake_python(Pump* p) {
  uint64_t one = 1;
  ssize_t r = write(p->efd, &one, sizeof one);
  (void)r;  // EAGAIN means the counter is already hot — Python will wake
}

void mark_dead(Pump* p, Conn* c) {
  if (c->dead) return;
  c->dead = true;
  if (!c->closed_reported) {
    c->closed_reported = true;
    p->closed.push_back(c->id);
    wake_python(p);
  }
}

// Parse complete frames out of c->stage (caller holds mu).  A malformed
// header or CRC mismatch kills the connection — identical to the Python
// read loop's FrameError behavior.
void parse_frames(Pump* p, Conn* c) {
  bool produced = false;
  for (;;) {
    size_t avail = c->stage.size() - c->stage_off;
    if (avail < kHeaderSize) break;
    const uint8_t* h = c->stage.data() + c->stage_off;
    uint32_t magic, msg_len, payload_len, flags, msg_crc, header_crc;
    memcpy(&magic, h, 4);
    memcpy(&msg_len, h + 4, 4);
    memcpy(&payload_len, h + 8, 4);
    memcpy(&flags, h + 12, 4);
    memcpy(&msg_crc, h + 16, 4);
    memcpy(&header_crc, h + 20, 4);
    if (magic != kMagic || msg_len > kMaxFrame || payload_len > kMaxFrame ||
        t3fs_crc32c(h, 20, 0) != header_crc) {
      mark_dead(p, c);
      break;
    }
    uint64_t need = kHeaderSize + static_cast<uint64_t>(msg_len) + payload_len;
    if (avail < need) break;
    const uint8_t* body = h + kHeaderSize;
    if (msg_len > 0 && t3fs_crc32c(body, msg_len, 0) != msg_crc) {
      mark_dead(p, c);
      break;
    }
    uint8_t* data = p->buf_alloc(msg_len + static_cast<size_t>(payload_len));
    memcpy(data, body, msg_len + static_cast<size_t>(payload_len));
    p->out.push_back(Frame{c->id, flags, msg_len, payload_len, data});
    p->out_bytes += msg_len + static_cast<size_t>(payload_len);
    p->rx_frames++;
    p->rx_bytes += msg_len + static_cast<size_t>(payload_len);
    produced = true;
    c->stage_off += need;
  }
  // compact once the consumed prefix dominates (amortized O(1) per byte)
  if (c->stage_off > 0 &&
      (c->stage_off >= c->stage.size() || c->stage_off > (1u << 20))) {
    c->stage.erase(c->stage.begin(), c->stage.begin() + c->stage_off);
    c->stage_off = 0;
  }
  if (produced) wake_python(p);
}

// Free a dead conn once no SQE references it (caller holds mu).
void maybe_reap(Pump* p, uint32_t conn_id) {
  auto it = p->conns.find(conn_id);
  if (it == p->conns.end()) return;
  Conn* c = it->second.get();
  if (c->dead && !c->recv_armed && !c->send_armed) {
    release_txq(p, c);     // no armed SQE: pins are safe to drop
    close(c->fd);
    p->conns.erase(it);
  }
}

void pump_thread(Pump* p) {
  std::vector<std::pair<uint64_t, int32_t>> batch;
  for (;;) {
    // wait for at least one completion
    unsigned head = __atomic_load_n(p->cq_head, __ATOMIC_RELAXED);
    unsigned tail = __atomic_load_n(p->cq_tail, __ATOMIC_ACQUIRE);
    if (head == tail) {
      int r = sys_io_uring_enter(p->ring_fd, 0, 1, IORING_ENTER_GETEVENTS);
      if (r < 0 && errno != EINTR && errno != EAGAIN) return;
      tail = __atomic_load_n(p->cq_tail, __ATOMIC_ACQUIRE);
    }
    batch.clear();
    while (head != tail) {
      const io_uring_cqe& c = p->cqes[head & *p->cq_mask];
      batch.emplace_back(c.user_data, c.res);
      head++;
    }
    __atomic_store_n(p->cq_head, head, __ATOMIC_RELEASE);
    if (p->stopping.load(std::memory_order_acquire)) return;

    std::lock_guard lk(p->mu);
    for (auto [ud, res] : batch) {
      uint32_t conn_id = static_cast<uint32_t>(ud >> 2);
      Op op = static_cast<Op>(ud & 3);
      auto it = p->conns.find(conn_id);
      if (it == p->conns.end()) continue;   // closed + erased meanwhile
      Conn* c = it->second.get();
      if (op == OP_RECV) {
        c->recv_armed = false;
        if (res <= 0) {
          if (res == -EINTR || res == -EAGAIN) {
            arm_recv(p, c);
          } else {
            mark_dead(p, c);   // 0 = peer EOF, <0 = socket error
          }
        } else {
          c->stage.insert(c->stage.end(), c->rbuf.begin(),
                          c->rbuf.begin() + res);
          parse_frames(p, c);
          arm_recv(p, c);
        }
      } else if (op == OP_SEND) {
        c->send_armed = false;
        if (res < 0) {
          if (res == -EINTR || res == -EAGAIN) {
            arm_send(p, c);
          } else {
            mark_dead(p, c);
          }
        } else {
          c->tx_off += static_cast<size_t>(res);
          c->tx_bytes -= static_cast<size_t>(res);
          if (c->tx_off >= c->txq.front().size()) {
            finish_tx_front(p, c);
          }
          arm_send(p, c);
        }
      }
      maybe_reap(p, conn_id);
    }
    // re-arm sweep: an SQ-full moment may have left a conn unarmed with
    // no completion to retrigger it; conns are few, so this is cheap
    for (auto& [id, c] : p->conns) {
      arm_recv(p, c.get());
      arm_send(p, c.get());
    }
    submit_locked(p);
  }
}

}  // namespace

extern "C" {

struct T3fsPumpEvt {
  uint64_t data;        // frame: heap buffer (msg||payload); closed: 0;
                        // tx-release: the pin token
  uint32_t conn_id;
  uint32_t flags;
  uint32_t msg_len;
  uint32_t payload_len;
  int32_t kind;         // 0 = frame, 1 = closed, 2 = tx-release
  int32_t _pad;
};

void* t3fs_pump_create(unsigned entries) {
  io_uring_params prm;
  memset(&prm, 0, sizeof prm);
  auto p = std::make_unique<Pump>();
  p->ring_fd = sys_io_uring_setup(entries, &prm);
  if (p->ring_fd < 0) return nullptr;
  p->sq_entries = prm.sq_entries;
  p->single_mmap = prm.features & IORING_FEAT_SINGLE_MMAP;
  p->sq_ring_sz = prm.sq_off.array + prm.sq_entries * sizeof(unsigned);
  p->cq_ring_sz = prm.cq_off.cqes + prm.cq_entries * sizeof(io_uring_cqe);
  if (p->single_mmap)
    p->sq_ring_sz = p->cq_ring_sz = std::max(p->sq_ring_sz, p->cq_ring_sz);
  p->sq_ring = mmap(nullptr, p->sq_ring_sz, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, p->ring_fd, IORING_OFF_SQ_RING);
  if (p->sq_ring == MAP_FAILED) return nullptr;
  p->cq_ring = p->single_mmap
      ? p->sq_ring
      : mmap(nullptr, p->cq_ring_sz, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, p->ring_fd, IORING_OFF_CQ_RING);
  if (p->cq_ring == MAP_FAILED) return nullptr;
  p->sqes_sz = prm.sq_entries * sizeof(io_uring_sqe);
  p->sqes = static_cast<io_uring_sqe*>(
      mmap(nullptr, p->sqes_sz, PROT_READ | PROT_WRITE,
           MAP_SHARED | MAP_POPULATE, p->ring_fd, IORING_OFF_SQES));
  if (p->sqes == MAP_FAILED) return nullptr;
  p->sq_head = ring_ptr<unsigned>(p->sq_ring, prm.sq_off.head);
  p->sq_tail = ring_ptr<unsigned>(p->sq_ring, prm.sq_off.tail);
  p->sq_mask = ring_ptr<unsigned>(p->sq_ring, prm.sq_off.ring_mask);
  p->sq_array = ring_ptr<unsigned>(p->sq_ring, prm.sq_off.array);
  p->cq_head = ring_ptr<unsigned>(p->cq_ring, prm.cq_off.head);
  p->cq_tail = ring_ptr<unsigned>(p->cq_ring, prm.cq_off.tail);
  p->cq_mask = ring_ptr<unsigned>(p->cq_ring, prm.cq_off.ring_mask);
  p->cqes = ring_ptr<io_uring_cqe>(p->cq_ring, prm.cq_off.cqes);
  p->efd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  if (p->efd < 0) return nullptr;
  Pump* raw = p.release();
  raw->th = std::thread(pump_thread, raw);
  return raw;
}

int t3fs_pump_eventfd(void* h) {
  return static_cast<Pump*>(h)->efd;
}

// Register fd (pump takes ownership) -> conn_id > 0, or -errno.
int64_t t3fs_pump_add(void* h, int fd) {
  auto* p = static_cast<Pump*>(h);
  std::lock_guard lk(p->mu);
  uint32_t id = p->next_id++;
  auto c = std::make_unique<Conn>();
  c->fd = fd;
  c->id = id;
  Conn* raw = c.get();
  p->conns.emplace(id, std::move(c));
  if (!arm_recv(p, raw)) {
    // SQ full: nothing was published for this conn, safe to back out
    p->conns.erase(id);
    close(fd);                   // pump owns the fd from the call on
    return -EAGAIN;
  }
  // a submit failure must NOT tear the conn down: the RECV SQE is
  // already published (sq_tail advanced) and references c->rbuf/fd —
  // freeing them would hand the kernel a dangling buffer when a later
  // submit pushes the ring (the "published SQEs are never abandoned"
  // contract).  The next submit from any operation retries it.
  submit_locked(p);
  return id;
}

// Queue a complete frame for sending; returns the conn's queued-bytes
// depth (for caller-side backpressure) or -errno.
int64_t t3fs_pump_send(void* h, uint32_t conn_id, const uint8_t* data,
                       uint64_t len) {
  auto* p = static_cast<Pump*>(h);
  std::lock_guard lk(p->mu);
  auto it = p->conns.find(conn_id);
  if (it == p->conns.end() || it->second->dead) return -EPIPE;
  Conn* c = it->second.get();
  TxEntry e;
  e.hdr.assign(data, data + len);
  p->tx_staged_bytes += len;
  c->txq.push_back(std::move(e));
  c->tx_bytes += len;
  arm_send(p, c);
  // submit failure: the SQE (if armed) stays published and the next
  // submit pushes it; the frame itself is safely queued either way
  submit_locked(p);
  return static_cast<int64_t>(c->tx_bytes);
}

// Zero-copy send: the small header+msg half is staged (copied), the
// payload stays BORROWED from the caller until this entry's tx-release
// event (kind=2, data=token) — the caller must pin the payload until
// then.  The staging copy (native_conn.py
// "SLOWER here" comment) is gone for the bulk half.
int64_t t3fs_pump_send2(void* h, uint32_t conn_id, const uint8_t* hdr,
                        uint64_t hdr_len, const uint8_t* pay,
                        uint64_t pay_len, uint64_t token) {
  auto* p = static_cast<Pump*>(h);
  std::lock_guard lk(p->mu);
  auto it = p->conns.find(conn_id);
  if (it == p->conns.end() || it->second->dead) return -EPIPE;
  Conn* c = it->second.get();
  TxEntry e;
  e.hdr.assign(hdr, hdr + hdr_len);
  e.pay = pay;
  e.pay_len = static_cast<size_t>(pay_len);
  e.token = token;
  p->tx_staged_bytes += hdr_len;
  p->tx_zc_bytes += pay_len;
  c->txq.push_back(std::move(e));
  c->tx_bytes += hdr_len + pay_len;
  arm_send(p, c);
  submit_locked(p);
  return static_cast<int64_t>(c->tx_bytes);
}

// Copy counters: [tx_staged, tx_zc, rx_frames, rx_bytes].
void t3fs_pump_stats(void* h, uint64_t out[4]) {
  auto* p = static_cast<Pump*>(h);
  std::lock_guard lk(p->mu);
  out[0] = p->tx_staged_bytes;
  out[1] = p->tx_zc_bytes;
  out[2] = p->rx_frames;
  out[3] = p->rx_bytes;
}

int64_t t3fs_pump_tx_depth(void* h, uint32_t conn_id) {
  auto* p = static_cast<Pump*>(h);
  std::lock_guard lk(p->mu);
  auto it = p->conns.find(conn_id);
  if (it == p->conns.end()) return -EPIPE;
  return static_cast<int64_t>(it->second->tx_bytes);
}

// Drain completed events (non-blocking).  Ownership of evt.data moves to
// the caller (t3fs_pump_free).
int t3fs_pump_poll(void* h, T3fsPumpEvt* out, unsigned max) {
  auto* p = static_cast<Pump*>(h);
  std::lock_guard lk(p->mu);
  bool was_high = p->out_bytes >= kRxHighWater;
  unsigned n = 0;
  while (n < max && !p->out.empty()) {
    Frame& f = p->out.front();
    out[n] = T3fsPumpEvt{reinterpret_cast<uint64_t>(f.data), f.conn_id,
                         f.flags, f.msg_len, f.payload_len, 0, 0};
    p->out_bytes -= f.msg_len + static_cast<size_t>(f.payload_len);
    p->out.pop_front();
    n++;
  }
  // tx-releases BEFORE closed events: a closed conn's pins must all be
  // dropped by the time Python tears the connection down
  while (n < max && !p->released.empty()) {
    auto [cid, token] = p->released.front();
    out[n] = T3fsPumpEvt{token, cid, 0, 0, 0, 2, 0};
    p->released.pop_front();
    n++;
  }
  while (n < max && !p->closed.empty()) {
    out[n] = T3fsPumpEvt{0, p->closed.front(), 0, 0, 0, 1, 0};
    p->closed.pop_front();
    n++;
  }
  if (was_high && p->out_bytes < kRxHighWater) {
    // drain crossed the high water downward: resume the paused RECVs
    for (auto& [id, c] : p->conns) arm_recv(p, c.get());
    submit_locked(p);
  }
  return static_cast<int>(n);
}

// Plain free — safe WITHOUT the pump handle, so Python-side finalizers
// on zero-copy RX memoryviews may run after pump destruction.  Buffers
// freed this way do not return to the pool.
void t3fs_pump_free(uint64_t data) {
  delete[] reinterpret_cast<uint8_t*>(data);
}

// Pool-returning free for the hot drain path (pump guaranteed alive:
// called inside the eventfd callback).  `size` is the frame's
// msg_len+payload_len, which maps back to the allocation's size class.
void t3fs_pump_free2(void* h, uint64_t data, uint64_t size) {
  auto* p = static_cast<Pump*>(h);
  std::lock_guard lk(p->mu);
  p->buf_free(reinterpret_cast<uint8_t*>(data),
              static_cast<size_t>(size));
}

// Close a connection: shuts the socket down (the in-flight RECV
// completes with 0/-ECONNRESET and the pump reaps the rest).
void t3fs_pump_close(void* h, uint32_t conn_id) {
  auto* p = static_cast<Pump*>(h);
  std::lock_guard lk(p->mu);
  auto it = p->conns.find(conn_id);
  if (it == p->conns.end()) return;
  Conn* c = it->second.get();
  c->closed_reported = true;    // caller initiated; no event needed
  c->dead = true;
  shutdown(c->fd, SHUT_RDWR);
  // fd closes (and the Conn frees) once no SQE references it: if
  // nothing is armed we can drop it now, else the CQE handler sees
  // dead=true, skips re-arm, and the erase happens in destroy or at
  // next completion below.
  if (!c->recv_armed && !c->send_armed) {
    release_txq(p, c);
    close(c->fd);
    p->conns.erase(it);
  }
}

void t3fs_pump_destroy(void* h) {
  auto* p = static_cast<Pump*>(h);
  p->stopping.store(true, std::memory_order_release);
  {
    std::lock_guard lk(p->mu);
    io_uring_sqe* sqe = sqe_alloc(p);
    if (sqe != nullptr) {
      sqe->opcode = IORING_OP_NOP;
      sqe->user_data = OP_NOP;
    }
    submit_locked(p);
  }
  if (p->th.joinable()) p->th.join();
  for (auto& [id, c] : p->conns) close(c->fd);
  p->conns.clear();
  delete p;
}

}  // extern "C"
