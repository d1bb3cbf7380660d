// t3fs native chunk engine — C++ physical chunk store for one storage target.
//
// The port's copy of t3fs/native/chunk_engine.cpp, built with aio_reader.cpp
// into one host library by t3fs_torch/ops/_build.py (host_library).
//
// Reference analogs (SURVEY.md §2.3): the C++ ChunkStore v1 (256 files per
// size class, bitmap allocation, chunk metadata in LevelDB/RocksDB,
// docs/design_notes.md:286) and the Rust chunk_engine v2 (allocator hierarchy
// Chunk->Group->File with bitmaps, RocksDB WriteBatch crash atomicity,
// src/storage/chunk_engine/src/core/engine.rs:31-712).  This is a fresh
// design, not a translation: one sparse data file per power-of-two size
// class, group bitmaps (256 blocks/group) for allocation, and a CRC-framed
// write-ahead metadata log with snapshot compaction replacing RocksDB.
//
// Crash atomicity: every metadata mutation is one WAL record, fsync'd before
// the in-memory index flips (when sync_writes).  COW data writes go to a
// freshly allocated block, so a torn write can never corrupt a committed
// chunk; replaying the WAL after a crash yields exactly the pre- or
// post-state of each operation (the Rust engine gets this from RocksDB
// WriteBatch; we get it from single-record atomicity + length/CRC framing).
//
// Exposed as a C ABI consumed by Python via ctypes
// (t3fs_torch/storage/native_engine.py) — the cxx-bridge analog of
// src/storage/chunk_engine/src/cxx.rs:368-600.

#include <algorithm>
#include <array>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <shared_mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <linux/falloc.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli) — hardware SSE4.2 path with table fallback + combine.
// Reference analog: folly::crc32c + crc32c_combine (fbs/storage/Common.h:158,191).
// ---------------------------------------------------------------------------

uint32_t crc32c_table[8][256];

struct TableInit {
  TableInit() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int j = 0; j < 8; j++) c = (c >> 1) ^ ((c & 1) ? poly : 0);
      crc32c_table[0][i] = c;
    }
    for (int t = 1; t < 8; t++)
      for (uint32_t i = 0; i < 256; i++)
        crc32c_table[t][i] =
            (crc32c_table[t - 1][i] >> 8) ^ crc32c_table[0][crc32c_table[t - 1][i] & 0xFF];
  }
} table_init;

uint32_t crc32c_sw(const uint8_t* p, size_t n, uint32_t crc) {
  crc = ~crc;
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    w ^= crc;
    crc = crc32c_table[7][w & 0xFF] ^ crc32c_table[6][(w >> 8) & 0xFF] ^
          crc32c_table[5][(w >> 16) & 0xFF] ^ crc32c_table[4][(w >> 24) & 0xFF] ^
          crc32c_table[3][(w >> 32) & 0xFF] ^ crc32c_table[2][(w >> 40) & 0xFF] ^
          crc32c_table[1][(w >> 48) & 0xFF] ^ crc32c_table[0][(w >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ crc32c_table[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

#if defined(__SSE4_2__)
uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t crc) {
  uint64_t c = ~crc;
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    c = _mm_crc32_u64(c, w);
    p += 8;
    n -= 8;
  }
  while (n--) c = _mm_crc32_u8(static_cast<uint32_t>(c), *p++);
  return ~static_cast<uint32_t>(c);
}
#endif

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc = 0) {
#if defined(__SSE4_2__)
  return crc32c_hw(p, n, crc);
#else
  return crc32c_sw(p, n, crc);
#endif
}

// GF(2) 32x32 matrix ops for crc32c_combine (same math as the reference's
// folly::crc32c_combine; matrices over the reflected polynomial).
struct Mat32 {
  uint32_t col[32];  // col[i] = matrix * e_i
};

uint32_t mat_apply(const Mat32& m, uint32_t v) {
  uint32_t r = 0;
  for (int i = 0; i < 32 && v; i++, v >>= 1)
    if (v & 1) r ^= m.col[i];
  return r;
}

Mat32 mat_mul(const Mat32& a, const Mat32& b) {
  Mat32 r;
  for (int i = 0; i < 32; i++) r.col[i] = mat_apply(a, b.col[i]);
  return r;
}

uint32_t crc32c_combine(uint32_t crc_a, uint32_t crc_b, uint64_t len_b) {
  if (len_b == 0) return crc_a;
  // one-byte shift matrix Mb (reflected): state' = table-step(state)
  Mat32 mb;
  for (int i = 0; i < 32; i++) {
    uint32_t v = 1u << i;
    mb.col[i] = (v >> 8) ^ crc32c_table[0][v & 0xFF];
  }
  // crc(a||b) = (Mb^len_b applied to crc_a-as-raw) ^ crc_b, with the affine
  // init/final terms cancelling exactly as in the linear-algebra derivation
  // (t3fs_torch/ops/crc32c.py combine()).
  Mat32 acc{};
  for (int i = 0; i < 32; i++) acc.col[i] = 1u << i;  // identity
  Mat32 sq = mb;
  uint64_t n = len_b;
  while (n) {
    if (n & 1) acc = mat_mul(sq, acc);
    sq = mat_mul(sq, sq);
    n >>= 1;
  }
  return mat_apply(acc, crc_a) ^ crc_b;
}

// ---------------------------------------------------------------------------
// Engine
// ---------------------------------------------------------------------------

thread_local std::string g_error;

constexpr uint64_t kMinChunk = 4096;        // test-friendly floor (ref: 64 KiB)
constexpr uint64_t kMaxChunk = 64ull << 20;
constexpr uint32_t kGroupBlocks = 256;      // blocks per allocator group
constexpr uint32_t kWalMagic = 0x74334653;  // "t3FS"

using Cid = std::array<uint8_t, 16>;

struct Meta {
  uint64_t length = 0;
  uint64_t update_ver = 0;
  uint64_t commit_ver = 0;
  uint64_t chain_ver = 0;
  uint32_t checksum = 0;
  uint32_t state = 0;  // 0=COMMIT 1=DIRTY
};

struct Slot {
  uint32_t size_class_log2 = 0;  // block size = 1 << log2
  uint64_t block = 0;
  Meta meta;
  // process-lifetime allocation generation: bumped on every index flip so
  // lock-free readers can detect remove+recreate ABA even when the new
  // incarnation has identical meta AND lands on the same block (locate()
  // returns it; not persisted — uniqueness within one process suffices)
  uint64_t gen = 0;
};

enum WalOp : uint8_t { kPut = 1, kSetMeta = 2, kRemove = 3 };

struct SizeClass {
  int fd = -1;
  std::vector<uint64_t> bitmap;  // 1 bit per block, grows by groups
  uint64_t alloc_hint = 0;
  uint64_t high_water = 0;       // blocks ever allocated (file length / bs)
  std::set<uint64_t> punch_pending;  // freed since last punch pass
  // restart rescan: instead of materializing every pre-restart free block
  // in punch_pending (O(free blocks) of std::set nodes on a mostly-empty
  // target), sweep the bitmap once with a cursor in bounded batches
  bool punch_rescan = false;
  uint64_t punch_cursor = 0;
  // PUNCH_HOLE unsupported on this fs (EOPNOTSUPP): stop queueing/punching
  bool punch_disabled = false;
};

class Engine {
 public:
  std::string root;
  bool sync_writes;
  std::string error;

  Engine(std::string r, bool sync) : root(std::move(r)), sync_writes(sync) {}

  bool open() {
    if (::mkdir(root.c_str(), 0755) != 0 && errno != EEXIST)
      return fail("mkdir " + root);
    if (!load_snapshot()) return false;
    uint64_t valid_wal = 0;
    if (!replay_wal(&valid_wal)) return false;
    rebuild_allocator();
    wal_fd_ = ::open((root + "/meta.wal").c_str(),
                     O_RDWR | O_CREAT | O_APPEND, 0644);
    if (wal_fd_ < 0) return fail("open wal");
    // Drop any torn tail NOW: with O_APPEND, new records would otherwise
    // land behind the garbage and be lost by the next replay.
    struct stat st;
    if (fstat(wal_fd_, &st) == 0 &&
        static_cast<uint64_t>(st.st_size) > valid_wal) {
      if (::ftruncate(wal_fd_, valid_wal) != 0)
        return fail("truncate torn wal tail");
    }
    return true;
  }

  ~Engine() {
    for (auto& [lg, sc] : classes_)
      if (sc.fd >= 0) ::close(sc.fd);
    if (wal_fd_ >= 0) ::close(wal_fd_);
  }

  // ---- public ops (each takes the exclusive lock; reads take shared) ----

  bool put(const Cid& cid, const uint8_t* data, uint64_t len,
           uint64_t chunk_size, const Meta& meta) {
    uint32_t lg = class_log2(std::max<uint64_t>(chunk_size, len));
    if (!lg) return fail("bad chunk size");
    // COW: reserve the block under the lock, then write+sync the data with
    // the lock RELEASED — the fresh block is invisible to readers until the
    // index flip, and holding the exclusive lock across fdatasync (possibly
    // hundreds of ms) would stall every shared-lock reader on the target.
    uint64_t block;
    int data_fd;
    uint64_t bs = 1ull << lg;
    {
      std::unique_lock lk(mu_);
      SizeClass& sc = get_class(lg);
      if (sc.fd < 0) return false;
      block = allocate(sc);
      data_fd = sc.fd;
    }
    if (pwrite_all(data_fd, data, len, block * bs) < 0) {
      std::unique_lock lk(mu_);
      release(get_class(lg), block);
      return fail("pwrite data");
    }
    if (sync_writes && ::fdatasync(data_fd) != 0) {
      std::unique_lock lk(mu_);
      release(get_class(lg), block);
      return fail("fdatasync data");
    }
    Slot s{lg, block, meta};
    s.meta.length = len;
    std::unique_lock lk(mu_);
    s.gen = ++gen_counter_;
    if (!wal_append_put(cid, s)) { release(get_class(lg), block); return false; }
    auto it = index_.find(cid);
    if (it != index_.end()) {
      release(get_class(it->second.size_class_log2), it->second.block);
      it->second = s;
    } else {
      index_.emplace(cid, s);
    }
    maybe_compact_locked();
    return true;
  }

  int read(const Cid& cid, uint64_t off, uint64_t want, uint8_t* out,
           uint64_t* out_len) {
    std::shared_lock lk(mu_);
    auto it = index_.find(cid);
    if (it == index_.end()) return 0;
    const Slot& s = it->second;
    uint64_t n = off < s.meta.length
                     ? std::min(want, s.meta.length - off) : 0;
    *out_len = n;
    if (n == 0) return 1;
    uint64_t bs = 1ull << s.size_class_log2;
    int fd = classes_.at(s.size_class_log2).fd;
    if (::pread(fd, out, n, s.block * bs + off) != static_cast<ssize_t>(n)) {
      // only the thread-local error here: fail() writes the shared error
      // string, which would race under the shared (reader) lock
      g_error = std::string("pread: ") + strerror(errno);
      return -1;
    }
    return 1;
  }

  // One-call hot read for the ring data plane: meta snapshot + pread +
  // optional full-chunk CRC verify under a SINGLE shared-lock
  // acquisition, landing bytes straight in a caller-provided buffer
  // (the registered arena / shm alias).  Because the pread runs under
  // the lock, the returned meta pairs atomically with the bytes — no
  // re-check protocol.  want == 0 means "to end of chunk".
  // Returns 1 = ok, 0 = not found, -1 = io error, -2 = crc mismatch.
  int read_into(const Cid& cid, uint64_t off, uint64_t want, uint8_t* out,
                uint64_t cap, int verify, uint64_t* out_len, Meta* meta) {
    std::shared_lock lk(mu_);
    auto it = index_.find(cid);
    if (it == index_.end()) return 0;
    const Slot& s = it->second;
    *meta = s.meta;
    uint64_t w = want ? want : (off < s.meta.length ? s.meta.length - off : 0);
    uint64_t n = off < s.meta.length
                     ? std::min(w, s.meta.length - off) : 0;
    n = std::min(n, cap);
    *out_len = n;
    if (n == 0) return 1;
    uint64_t bs = 1ull << s.size_class_log2;
    int fd = classes_.at(s.size_class_log2).fd;
    if (::pread(fd, out, n, s.block * bs + off) != static_cast<ssize_t>(n)) {
      g_error = std::string("pread: ") + strerror(errno);
      return -1;
    }
    if (verify && off == 0 && n == s.meta.length &&
        crc32c(out, n, 0) != s.meta.checksum)
      return -2;
    return 1;
  }

  // Lock-free-read descriptor: where the chunk's bytes live RIGHT NOW.
  // Callers pread(fd, abs_off, n) outside any engine lock, then re-check
  // get_meta: updates are COW (a put moves the chunk to a fresh block and
  // bumps update_ver), a freed block is never punched or re-allocated
  // while still owned, so unchanged meta => the preaded bytes are that
  // version's bytes.  This is the seam the aio/io_uring reader uses
  // (reference: AioStatus.h:50-69 reads into caller buffers the same way;
  // the Rust engine's Arc<ChunkPos> solves the same race by refcounting).
  int locate(const Cid& cid, uint64_t off, uint64_t want,
             int32_t* fd, uint64_t* abs_off, uint64_t* n, uint64_t* gen) {
    std::shared_lock lk(mu_);
    auto it = index_.find(cid);
    if (it == index_.end()) return 0;
    const Slot& s = it->second;
    *n = off < s.meta.length ? std::min(want, s.meta.length - off) : 0;
    uint64_t bs = 1ull << s.size_class_log2;
    auto cit = classes_.find(s.size_class_log2);
    if (cit == classes_.end() || cit->second.fd < 0) return 0;
    *fd = cit->second.fd;
    *abs_off = s.block * bs + off;
    *gen = s.gen;
    return 1;
  }

  int get_meta(const Cid& cid, Meta* out) {
    std::shared_lock lk(mu_);
    auto it = index_.find(cid);
    if (it == index_.end()) return 0;
    *out = it->second.meta;
    return 1;
  }

  bool set_meta(const Cid& cid, const Meta& meta) {
    std::unique_lock lk(mu_);
    auto it = index_.find(cid);
    if (it == index_.end()) return fail("chunk not found");
    if (!wal_append_meta(kSetMeta, cid, meta)) return false;
    it->second.meta = meta;
    maybe_compact_locked();
    return true;
  }

  int remove(const Cid& cid) {
    std::unique_lock lk(mu_);
    auto it = index_.find(cid);
    if (it == index_.end()) return 0;
    if (!wal_append_meta(kRemove, cid, Meta{})) return -1;
    release(get_class(it->second.size_class_log2), it->second.block);
    index_.erase(it);
    maybe_compact_locked();
    return 1;
  }

  // range scan [lo, hi); returns up to cap rows, sets *count to total.
  uint64_t query_range(const Cid& lo, const Cid& hi, uint8_t* rows,
                       uint64_t cap, uint64_t row_bytes) {
    std::shared_lock lk(mu_);
    uint64_t total = 0;
    for (auto it = index_.lower_bound(lo);
         it != index_.end() && it->first < hi; ++it, ++total) {
      if (total < cap) encode_row(rows + total * row_bytes, it->first,
                                  it->second.meta);
    }
    return total;
  }

  void stats(uint64_t* chunks, uint64_t* used, uint64_t* allocated) {
    std::shared_lock lk(mu_);
    *chunks = index_.size();
    uint64_t u = 0, a = 0;
    for (auto& [cid, s] : index_) u += s.meta.length;
    for (auto& [lg, sc] : classes_) a += sc.high_water << lg;
    *used = u;
    *allocated = a;
  }

  // Compact: write snapshot of the live index, truncate the WAL.  Called
  // explicitly (background DumpWorker analog) or on close.
  bool compact() {
    std::unique_lock lk(mu_);
    return snapshot_locked();
  }

  // Punch-hole reclaim of freed blocks (reference PunchHoleWorker analog):
  // returns bytes reclaimed.  release() queues each freed block; this
  // drains up to max_blocks of the queue under the exclusive lock (so a
  // block can't be re-allocated between the free-bit check and the punch)
  // — the lock hold is O(drained), never a scan of the whole allocator.
  uint64_t punch_freed(uint64_t max_blocks) {
    std::unique_lock lk(mu_);
    uint64_t reclaimed = 0, attempts = 0;
    for (auto& [lg, sc] : classes_) {
      if (sc.fd < 0) continue;
      if (sc.punch_disabled) {
        sc.punch_pending.clear();
        sc.punch_rescan = false;
        continue;
      }
      uint64_t bs = 1ull << lg;
      auto it = sc.punch_pending.begin();
      while (it != sc.punch_pending.end() && attempts < max_blocks) {
        uint64_t blk = *it;
        bool free_bit = blk / 64 >= sc.bitmap.size() ||
                        !(sc.bitmap[blk / 64] & (1ull << (blk % 64)));
        if (!free_bit) {           // re-allocated since freeing: stale entry
          it = sc.punch_pending.erase(it);
          continue;
        }
        attempts++;
        if (::fallocate(sc.fd, FALLOC_FL_PUNCH_HOLE | FALLOC_FL_KEEP_SIZE,
                        blk * bs, bs) == 0) {
          reclaimed += bs;
          it = sc.punch_pending.erase(it);
        } else if (errno == EOPNOTSUPP || errno == EINVAL || errno == ENOSYS) {
          sc.punch_disabled = true;  // fs can't punch: stop trying forever
          sc.punch_pending.clear();
          sc.punch_rescan = false;
          break;
        } else {
          break;                   // transient (EINTR/EIO): retry next pass,
        }                          // don't burn the budget on one sick class
      }
      if (sc.punch_disabled) continue;
      // restart sweep: punch free blocks below high_water in cursor order
      while (sc.punch_rescan && attempts < max_blocks) {
        if (sc.punch_cursor >= sc.high_water) {
          sc.punch_rescan = false;
          break;
        }
        uint64_t blk = sc.punch_cursor;
        bool free_bit = blk / 64 >= sc.bitmap.size() ||
                        !(sc.bitmap[blk / 64] & (1ull << (blk % 64)));
        if (free_bit) {
          attempts++;
          if (::fallocate(sc.fd, FALLOC_FL_PUNCH_HOLE | FALLOC_FL_KEEP_SIZE,
                          blk * bs, bs) != 0)
            break;                 // keep cursor: retry this block next pass
          reclaimed += bs;
        }
        sc.punch_cursor++;
      }
    }
    return reclaimed;
  }

  static void encode_row(uint8_t* p, const Cid& cid, const Meta& m) {
    memcpy(p, cid.data(), 16);
    memcpy(p + 16, &m, sizeof(Meta));
  }

 private:
  std::shared_mutex mu_;
  uint64_t gen_counter_ = 0;     // Slot::gen source (under mu_)
  std::map<Cid, Slot> index_;
  std::map<uint32_t, SizeClass> classes_;
  int wal_fd_ = -1;
  uint64_t wal_records_ = 0;

  bool fail(const std::string& msg) {
    error = msg + (errno ? std::string(": ") + strerror(errno) : "");
    return false;
  }

  static uint32_t class_log2(uint64_t size) {
    if (size == 0 || size > kMaxChunk) return 0;
    uint64_t c = kMinChunk;
    uint32_t lg = 12;
    while (c < size) { c <<= 1; lg++; }
    return lg;
  }

  SizeClass& get_class(uint32_t lg) {
    SizeClass& sc = classes_[lg];
    if (sc.fd < 0) {
      char path[512];
      snprintf(path, sizeof path, "%s/blocks_%u", root.c_str(), 1u << lg);
      sc.fd = ::open(path, O_RDWR | O_CREAT, 0644);
      if (sc.fd < 0) fail(std::string("open ") + path);
    }
    return sc;
  }

  uint64_t allocate(SizeClass& sc) {
    uint64_t nbits = sc.bitmap.size() * 64;
    for (uint64_t w = sc.alloc_hint / 64; w < sc.bitmap.size(); w++) {
      uint64_t inv = ~sc.bitmap[w];
      if (inv) {
        int bit = __builtin_ctzll(inv);
        uint64_t blk = w * 64 + bit;
        sc.bitmap[w] |= 1ull << bit;
        sc.alloc_hint = blk;
        sc.high_water = std::max(sc.high_water, blk + 1);
        sc.punch_pending.erase(blk);  // re-used: nothing left to punch
        return blk;
      }
    }
    // grow by one group (kGroupBlocks blocks)
    sc.bitmap.resize(sc.bitmap.size() + kGroupBlocks / 64, 0);
    sc.bitmap[nbits / 64] = 1;
    sc.alloc_hint = nbits;
    sc.high_water = std::max(sc.high_water, nbits + 1);
    return nbits;
  }

  static constexpr size_t kPunchPendingCap = 1 << 18;  // bound set memory

  void release(SizeClass& sc, uint64_t blk) {
    if (blk / 64 < sc.bitmap.size()) {
      sc.bitmap[blk / 64] &= ~(1ull << (blk % 64));
      sc.alloc_hint = std::min(sc.alloc_hint, blk);
      if (sc.punch_disabled) return;
      if (sc.punch_pending.size() >= kPunchPendingCap) {
        // overflow (punching persistently failing or far behind): fall
        // back to a full cursor sweep, which finds every free block with
        // O(1) memory, and drop the per-block queue
        sc.punch_pending.clear();
        sc.punch_rescan = true;
        sc.punch_cursor = 0;
        return;
      }
      if (!(sc.punch_rescan && blk >= sc.punch_cursor))
        sc.punch_pending.insert(blk);  // queue for background reclaim
    }
  }

  void mark_used(uint32_t lg, uint64_t blk) {
    SizeClass& sc = get_class(lg);
    if (blk / 64 >= sc.bitmap.size())
      sc.bitmap.resize((blk / 64 + kGroupBlocks / 64) /
                       (kGroupBlocks / 64) * (kGroupBlocks / 64), 0);
    sc.bitmap[blk / 64] |= 1ull << (blk % 64);
    sc.high_water = std::max(sc.high_water, blk + 1);
  }

  void rebuild_allocator() {
    for (auto& [cid, s] : index_) mark_used(s.size_class_log2, s.block);
    // reclaim pre-restart free blocks: holes punched in a past life
    // re-punch as cheap no-ops, blocks freed just before a crash get their
    // space back.  A cursor sweep (drained in punch_freed batches) instead
    // of inserting every free block into punch_pending — a near-empty
    // target with a high high_water would otherwise pay one std::set node
    // per free block up front.
    for (auto& [lg, sc] : classes_) {
      sc.punch_rescan = sc.high_water > 0;
      sc.punch_cursor = 0;
    }
  }

  // ---- WAL / snapshot ----
  // record: [u32 magic][u32 crc][u32 len][u8 op][16B cid][payload]
  //   crc covers [len..payload]; torn tail detected by magic/crc mismatch.

  bool wal_write(uint8_t op, const Cid& cid, const void* payload,
                 uint32_t plen) {
    std::vector<uint8_t> rec(12 + 1 + 16 + plen);
    uint32_t len = 1 + 16 + plen;
    memcpy(rec.data(), &kWalMagic, 4);
    memcpy(rec.data() + 8, &len, 4);
    rec[12] = op;
    memcpy(rec.data() + 13, cid.data(), 16);
    if (plen) memcpy(rec.data() + 29, payload, plen);
    uint32_t crc = crc32c(rec.data() + 8, rec.size() - 8);
    memcpy(rec.data() + 4, &crc, 4);
    if (pwrite_all(wal_fd_, rec.data(), rec.size(), -1) < 0)
      return fail("wal append");
    if (sync_writes && ::fdatasync(wal_fd_) != 0) return fail("wal fsync");
    wal_records_++;
    return true;
  }

  // Called by mutators AFTER index_ reflects the mutation (compacting inside
  // wal_write would snapshot pre-mutation state and truncate the record —
  // silent durability loss).
  void maybe_compact_locked() {
    if (wal_records_ > 1u << 18) snapshot_locked();  // bounded replay
  }

  bool wal_append_put(const Cid& cid, const Slot& s) {
    // explicit packed layout [u32 lg][u64 block][Meta] — matches replay_wal
    uint8_t p[12 + sizeof(Meta)];
    memcpy(p, &s.size_class_log2, 4);
    memcpy(p + 4, &s.block, 8);
    memcpy(p + 12, &s.meta, sizeof(Meta));
    return wal_write(kPut, cid, p, sizeof p);
  }

  bool wal_append_meta(uint8_t op, const Cid& cid, const Meta& m) {
    return wal_write(op, cid, &m, sizeof m);
  }

  static ssize_t pwrite_all(int fd, const void* buf, size_t n, off_t off) {
    const uint8_t* p = static_cast<const uint8_t*>(buf);
    size_t left = n;
    while (left) {
      ssize_t w = off < 0 ? ::write(fd, p, left)
                          : ::pwrite(fd, p, left, off + (n - left));
      if (w < 0) { if (errno == EINTR) continue; return -1; }
      p += w;
      left -= w;
    }
    return static_cast<ssize_t>(n);
  }

  bool load_snapshot() {
    int fd = ::open((root + "/meta.snap").c_str(), O_RDONLY);
    if (fd < 0) return true;  // no snapshot yet
    struct stat st;
    fstat(fd, &st);
    std::vector<uint8_t> buf(st.st_size);
    if (st.st_size && ::read(fd, buf.data(), buf.size()) !=
                          static_cast<ssize_t>(buf.size())) {
      ::close(fd);
      return fail("read snapshot");
    }
    ::close(fd);
    const uint64_t rec = 16 + sizeof(uint32_t) + sizeof(uint64_t) + sizeof(Meta);
    if (buf.size() < 8) return true;
    uint32_t magic, crc;
    memcpy(&magic, buf.data(), 4);
    memcpy(&crc, buf.data() + 4, 4);
    if (magic != kWalMagic ||
        crc != crc32c(buf.data() + 8, buf.size() - 8))
      return fail("snapshot corrupt");
    for (uint64_t off = 8; off + rec <= buf.size(); off += rec) {
      Cid cid;
      Slot s;
      memcpy(cid.data(), buf.data() + off, 16);
      memcpy(&s.size_class_log2, buf.data() + off + 16, 4);
      memcpy(&s.block, buf.data() + off + 20, 8);
      memcpy(&s.meta, buf.data() + off + 28, sizeof(Meta));
      index_[cid] = s;
    }
    return true;
  }

  bool replay_wal(uint64_t* valid_prefix) {
    *valid_prefix = 0;
    int fd = ::open((root + "/meta.wal").c_str(), O_RDONLY);
    if (fd < 0) return true;
    struct stat st;
    fstat(fd, &st);
    std::vector<uint8_t> buf(st.st_size);
    if (st.st_size && ::read(fd, buf.data(), buf.size()) !=
                          static_cast<ssize_t>(buf.size())) {
      ::close(fd);
      return fail("read wal");
    }
    ::close(fd);
    uint64_t off = 0;
    while (off + 12 <= buf.size()) {
      uint32_t magic, crc, len;
      memcpy(&magic, buf.data() + off, 4);
      memcpy(&crc, buf.data() + off + 4, 4);
      memcpy(&len, buf.data() + off + 8, 4);
      if (magic != kWalMagic || len < 17 || off + 12 + len > buf.size())
        break;  // torn tail — stop replay here
      if (crc != crc32c(buf.data() + off + 8, 4 + len)) break;
      const uint8_t* p = buf.data() + off + 12;
      uint8_t op = p[0];
      Cid cid;
      memcpy(cid.data(), p + 1, 16);
      const uint8_t* payload = p + 17;
      uint32_t plen = len - 17;
      if (op == kPut && plen >= 12 + sizeof(Meta)) {
        Slot s;
        memcpy(&s.size_class_log2, payload, 4);
        memcpy(&s.block, payload + 4, 8);
        memcpy(&s.meta, payload + 12, sizeof(Meta));
        index_[cid] = s;
      } else if (op == kSetMeta && plen >= sizeof(Meta)) {
        auto it = index_.find(cid);
        if (it != index_.end()) memcpy(&it->second.meta, payload, sizeof(Meta));
      } else if (op == kRemove) {
        index_.erase(cid);
      }
      wal_records_++;
      off += 12 + len;
      *valid_prefix = off;
    }
    return true;
  }

  bool snapshot_locked() {
    const uint64_t rec = 16 + sizeof(uint32_t) + sizeof(uint64_t) + sizeof(Meta);
    std::vector<uint8_t> buf(8 + rec * index_.size());
    memcpy(buf.data(), &kWalMagic, 4);
    uint64_t off = 8;
    for (auto& [cid, s] : index_) {
      memcpy(buf.data() + off, cid.data(), 16);
      memcpy(buf.data() + off + 16, &s.size_class_log2, 4);
      memcpy(buf.data() + off + 20, &s.block, 8);
      memcpy(buf.data() + off + 28, &s.meta, sizeof(Meta));
      off += rec;
    }
    uint32_t crc = crc32c(buf.data() + 8, buf.size() - 8);
    memcpy(buf.data() + 4, &crc, 4);
    std::string tmp = root + "/meta.snap.tmp";
    int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return fail("open snap tmp");
    if (pwrite_all(fd, buf.data(), buf.size(), -1) < 0 ||
        ::fsync(fd) != 0) {
      ::close(fd);
      return fail("write snapshot");
    }
    ::close(fd);
    if (::rename(tmp.c_str(), (root + "/meta.snap").c_str()) != 0)
      return fail("rename snapshot");
    // Make the rename durable BEFORE truncating the WAL: otherwise a crash
    // could persist the empty WAL while the directory still points at the
    // old snapshot — rolling the store back to the previous compaction.
    int dfd = ::open(root.c_str(), O_RDONLY | O_DIRECTORY);
    if (dfd >= 0) {
      ::fsync(dfd);
      ::close(dfd);
    }
    if (wal_fd_ >= 0) {
      ::ftruncate(wal_fd_, 0);
      ::lseek(wal_fd_, 0, SEEK_SET);
    }
    wal_records_ = 0;
    return true;
  }
};

Cid to_cid(const uint8_t* p) {
  Cid c;
  memcpy(c.data(), p, 16);
  return c;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

struct CeMeta {
  uint64_t length;
  uint64_t update_ver;
  uint64_t commit_ver;
  uint64_t chain_ver;
  uint32_t checksum;
  uint32_t state;
};
static_assert(sizeof(CeMeta) == sizeof(Meta), "ABI mismatch");

// row layout for query_range: [16B cid][CeMeta]
const uint64_t T3FS_CE_ROW_BYTES = 16 + sizeof(CeMeta);

void* t3fs_ce_open(const char* root, int sync_writes) {
  auto* e = new Engine(root, sync_writes != 0);
  if (!e->open()) {
    g_error = e->error;
    delete e;
    return nullptr;
  }
  return e;
}

void t3fs_ce_close(void* h) {
  auto* e = static_cast<Engine*>(h);
  if (e) e->compact();
  delete e;
}

const char* t3fs_ce_last_error(void* h) {
  auto* e = static_cast<Engine*>(h);
  if (e && !e->error.empty()) return e->error.c_str();
  return g_error.c_str();
}

// NULL-handle guard: a request that raced t3fs_ce_close must come back
// as an orderly error, never a nullptr member call (segfault observed
// when a straggler read drained after its node's engine closed)
static bool ce_null(void* h) {
  if (h) return false;
  g_error = "engine closed (null handle)";
  return true;
}

int t3fs_ce_put(void* h, const uint8_t* cid, const uint8_t* data,
                uint64_t len, uint64_t chunk_size, const CeMeta* meta) {
  if (ce_null(h)) return 0;
  auto* e = static_cast<Engine*>(h);
  Meta m;
  memcpy(&m, meta, sizeof m);
  return e->put(to_cid(cid), data, len, chunk_size, m) ? 1 : 0;
}

int t3fs_ce_read(void* h, const uint8_t* cid, uint64_t off, uint64_t len,
                 uint8_t* out, uint64_t* out_len) {
  if (ce_null(h)) return -1;
  return static_cast<Engine*>(h)->read(to_cid(cid), off, len, out, out_len);
}

int t3fs_ce_read_into(void* h, const uint8_t* cid, uint64_t off,
                      uint64_t want, uint8_t* out, uint64_t cap, int verify,
                      uint64_t* out_len, CeMeta* meta) {
  if (ce_null(h)) return -1;
  Meta m;
  int r = static_cast<Engine*>(h)->read_into(to_cid(cid), off, want, out,
                                             cap, verify, out_len, &m);
  if (r == 1 || r == -2) memcpy(meta, &m, sizeof m);
  return r;
}

int t3fs_ce_locate(void* h, const uint8_t* cid, uint64_t off, uint64_t want,
                   int32_t* fd, uint64_t* abs_off, uint64_t* n,
                   uint64_t* gen) {
  if (ce_null(h)) return 0;
  return static_cast<Engine*>(h)->locate(to_cid(cid), off, want, fd,
                                         abs_off, n, gen);
}

int t3fs_ce_get_meta(void* h, const uint8_t* cid, CeMeta* out) {
  if (ce_null(h)) return 0;
  Meta m;
  int r = static_cast<Engine*>(h)->get_meta(to_cid(cid), &m);
  if (r == 1) memcpy(out, &m, sizeof m);
  return r;
}

int t3fs_ce_set_meta(void* h, const uint8_t* cid, const CeMeta* meta) {
  if (ce_null(h)) return 0;
  Meta m;
  memcpy(&m, meta, sizeof m);
  return static_cast<Engine*>(h)->set_meta(to_cid(cid), m) ? 1 : 0;
}

int t3fs_ce_remove(void* h, const uint8_t* cid) {
  if (ce_null(h)) return 0;
  return static_cast<Engine*>(h)->remove(to_cid(cid));
}

uint64_t t3fs_ce_query_range(void* h, const uint8_t* lo, const uint8_t* hi,
                             uint8_t* rows, uint64_t cap) {
  if (ce_null(h)) return 0;
  return static_cast<Engine*>(h)->query_range(to_cid(lo), to_cid(hi), rows,
                                              cap, T3FS_CE_ROW_BYTES);
}

void t3fs_ce_stats(void* h, uint64_t* chunks, uint64_t* used,
                   uint64_t* allocated) {
  if (ce_null(h)) return;
  static_cast<Engine*>(h)->stats(chunks, used, allocated);
}

int t3fs_ce_compact(void* h) {
  if (ce_null(h)) return 0;
  return static_cast<Engine*>(h)->compact() ? 1 : 0;
}

uint64_t t3fs_ce_punch_freed(void* h, uint64_t max_blocks) {
  if (ce_null(h)) return 0;
  return static_cast<Engine*>(h)->punch_freed(max_blocks);
}

uint32_t t3fs_crc32c(const uint8_t* p, uint64_t n, uint32_t crc) {
  return crc32c(p, n, crc);
}

uint32_t t3fs_crc32c_sw(const uint8_t* p, uint64_t n, uint32_t crc) {
  return crc32c_sw(p, n, crc);
}

uint32_t t3fs_crc32c_combine(uint32_t a, uint32_t b, uint64_t len_b) {
  return crc32c_combine(a, b, len_b);
}

}  // extern "C"
