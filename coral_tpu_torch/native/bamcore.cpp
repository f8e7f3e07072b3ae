// bamcore: native BAM decoding engine for coral_tpu.
//
// Replaces the htslib layer the reference reaches through pysam
// (src/infer_breakpoint_graph.py fetch/count_coverage call sites) with a
// purpose-built scanner:
//   * one streaming pass over the BGZF stream (blocks inflated in parallel
//     with a thread pool, records parsed sequentially) producing a flat
//     structure-of-arrays record table consumed zero-copy by numpy;
//   * virtual-offset-addressed region re-decode for exact aligned-base
//     coverage (pysam count_coverage semantics incl. base-quality
//     thresholds and flag filters) and large-deletion gap extraction.
//
// Exposed as a C ABI for ctypes; no Python headers required.
//
// Three process-wide counters of payload bytes inflated, read by
// bc_counters(): by the scan (scan_inflated_bytes), by region decodes
// (decode_inflated_bytes), and the part of the latter inflated on more
// than one thread (decode_pooled_bytes).  They live outside any handle,
// so they outlast bc_close, and count always (one relaxed add a window).
// Two more count the records of region decodes: those answered from the
// scan's columns (decode_column_records, one relaxed add a call) and those
// walked from inflated bytes (decode_walked_records, one a run walked).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <algorithm>
#include <atomic>
#include <limits>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <thread>
#include <sys/stat.h>
#include <zlib.h>

namespace {

std::atomic<int64_t> g_scan_inflated{0};
std::atomic<int64_t> g_decode_inflated{0};
std::atomic<int64_t> g_decode_pooled{0};
std::atomic<int64_t> g_decode_column{0};
std::atomic<int64_t> g_decode_walked{0};

constexpr uint32_t kRefConsuming = (1u << 0) | (1u << 2) | (1u << 3) | (1u << 7) | (1u << 8);
constexpr uint32_t kQueryConsuming = (1u << 0) | (1u << 1) | (1u << 4) | (1u << 7) | (1u << 8);
constexpr uint32_t kAligned = (1u << 0) | (1u << 7) | (1u << 8);

// Walk a record's CIGAR (n_cigar ops at cig, its first base at reference
// pos) and call fn(rstart, rend, qoff, prev_end) for each aligned (M/=/X)
// block in order: its reference span [rstart, rend), the query offset of
// its first base, and the end of the aligned block before it (-1 for the
// first).
template <typename F>
inline void walk_aligned_blocks(const uint8_t* cig, int n_cigar, int64_t pos,
                                F&& fn) {
  int64_t rpos = pos, qpos = 0, prev_end = -1;
  for (int ci = 0; ci < n_cigar; ci++) {
    uint32_t c;
    memcpy(&c, cig + 4 * ci, 4);
    const uint32_t op = 1u << (c & 0xF);
    const int64_t n = c >> 4;
    if (op & kAligned) {
      fn(rpos, rpos + n, qpos, prev_end);
      prev_end = rpos + n;
    }
    if (op & kRefConsuming) rpos += n;
    if (op & kQueryConsuming) qpos += n;
  }
}

// The gap between an aligned block that starts at rstart and the one
// before it that ends at prev_end (>= 0).  The scan keeps each record's
// largest in its max_gap column and bc_del_gaps walks only the records
// whose max_gap exceeds min_del_len, so both must measure it here.
inline int64_t block_gap(int64_t prev_end, int64_t rstart) {
  const int64_t gap = rstart - prev_end;
  return gap < 0 ? -gap : gap;
}

// Allocator whose default-construct is a no-op: vector::resize() leaves the
// new region uninitialized instead of memsetting it.  The scan writes every
// element exactly once, so zero-filling would only double the page-fault
// and memory-write volume (first-touch faults are the dominant scan cost on
// virtualized hosts).
template <typename T>
struct DIAlloc : std::allocator<T> {
  template <typename U> struct rebind { using other = DIAlloc<U>; };
  template <typename U>
  void construct(U* p) noexcept { ::new (static_cast<void*>(p)) U; }
  template <typename U, typename... Args>
  void construct(U* p, Args&&... args) {
    ::new (static_cast<void*>(p)) U(std::forward<Args>(args)...);
  }
};

template <typename T>
using dvec = std::vector<T, DIAlloc<T>>;

// Grow-without-zero-fill: geometric reserve then uninitialized resize.
template <typename T>
inline void ensure_size(dvec<T>& v, size_t n) {
  if (v.size() >= n) return;
  if (v.capacity() < n) {
    size_t cap = v.capacity() * 2;
    v.reserve(cap > n ? cap : n);
  }
  v.resize(n);
}

struct BlockInfo {
  int64_t coffset;   // compressed offset of block start
  int32_t csize;     // compressed block size (whole gzip member)
  int32_t usize;     // uncompressed payload size (ISIZE)
};

struct GapRow {
  int64_t rec;
  int64_t next_start;
  int64_t prev_end;
  int64_t blk_first;
  int64_t blk_last;
};

struct ChimAln {
  int64_t qs, qe;
  int32_t ref_id;
  int64_t r1, r2;
  int8_t strand;   // +1 / -1
  int32_t mapq;
  double nm;       // per-aligned-base edit distance
};

struct BamCore {
  std::string path;
  FILE* fp = nullptr;
  std::string error;
  bool from_cache = false;   // record table loaded from a scan cache
  int nthreads = 1;          // threads a region decode inflates on

  // chimera tables (filled by bc_parse_sa)
  std::vector<int64_t> chim_rec;    // representative record idx per read
  std::vector<int64_t> chim_off;    // n_chim + 1
  std::vector<int32_t> chim_rl;     // read length per chimeric read
  std::vector<int64_t> aln_qs, aln_qe, aln_r1, aln_r2;
  std::vector<int32_t> aln_ref, aln_mapq;
  std::vector<int8_t> aln_strand;
  std::vector<double> aln_nm;

  // references
  std::vector<std::string> ref_names;
  std::vector<int64_t> ref_lens;

  // record table (structure of arrays); dvec: filled by direct writes
  // during the scan, never zero-initialized
  dvec<uint16_t> flag;
  dvec<int32_t> ref_id;
  dvec<int64_t> pos;
  dvec<int64_t> end;
  dvec<uint8_t> mapq;
  dvec<int32_t> qlen;
  dvec<int64_t> nm;
  dvec<uint64_t> voffset;   // coffset<<16 | offset-in-block-payload
  dvec<uint8_t> name_blob;
  dvec<int64_t> name_off;   // n+1
  dvec<uint8_t> sa_blob;
  dvec<int64_t> sa_off;
  dvec<int64_t> sa_len;
  dvec<int64_t> aligned;    // bases in the record's M/=/X ops
  dvec<int64_t> max_gap;    // largest gap between consecutive such ops

  // del-gap query scratch
  std::vector<GapRow> gaps;

  ~BamCore() { if (fp) fclose(fp); }
};

bool inflate_raw(const uint8_t* src, int n, uint8_t* dst, int cap, int* out_n) {
  z_stream s;
  memset(&s, 0, sizeof(s));
  if (inflateInit2(&s, -15) != Z_OK) return false;
  s.next_in = const_cast<uint8_t*>(src);
  s.avail_in = n;
  s.next_out = dst;
  s.avail_out = cap;
  int r = inflate(&s, Z_FINISH);
  *out_n = static_cast<int>(cap - s.avail_out);
  inflateEnd(&s);
  return r == Z_STREAM_END;
}

// Sequentially read one whole BGZF member at the current file position
// (assumed == coffset): header, BC subfield, compressed payload, trailer —
// one buffered fread stream and no fseek, so that a window's members are
// read back to back from stdio's readahead.  Returns false with err==""
// at clean EOF.
bool read_block_seq(FILE* fp, int64_t coffset, BlockInfo* bi,
                    std::vector<uint8_t>* mem, std::string* err) {
  uint8_t hdr[18];
  size_t got = fread(hdr, 1, sizeof(hdr), fp);
  if (got == 0) return false;
  if (got < sizeof(hdr) || hdr[0] != 0x1f || hdr[1] != 0x8b || hdr[2] != 8 ||
      !(hdr[3] & 4)) {
    *err = "bad BGZF block header";
    return false;
  }
  uint16_t xlen;
  memcpy(&xlen, hdr + 10, 2);
  // provisional: through the extra area; never smaller than the 18-byte
  // header we copy in (xlen < 6 cannot carry a BC subfield and errors
  // below, but must not overflow the buffer here)
  mem->resize(std::max<size_t>(12 + xlen, sizeof(hdr)));
  memcpy(mem->data(), hdr, sizeof(hdr));
  if (xlen > 6) {
    if (fread(mem->data() + 18, 1, xlen - 6, fp) !=
        static_cast<size_t>(xlen - 6)) {
      *err = "truncated BGZF extra";
      return false;
    }
  }
  int bsize = -1;
  const uint8_t* extra = mem->data() + 12;
  for (int p = 0; p + 4 <= xlen;) {
    uint16_t slen;
    memcpy(&slen, extra + p + 2, 2);
    if (extra[p] == 'B' && extra[p + 1] == 'C' && p + 6 <= xlen) {
      uint16_t v;
      memcpy(&v, extra + p + 4, 2);
      bsize = v + 1;
    }
    p += 4 + slen;
  }
  if (bsize < 0 || bsize < 12 + xlen + 8) {
    *err = "BGZF block missing BC subfield";
    return false;
  }
  mem->resize(bsize);
  size_t rest = bsize - 12 - xlen;
  if (fread(mem->data() + 12 + xlen, 1, rest, fp) != rest) {
    *err = "truncated BGZF block";
    return false;
  }
  uint32_t isize;
  memcpy(&isize, mem->data() + bsize - 4, 4);
  bi->coffset = coffset;
  bi->csize = bsize;
  bi->usize = static_cast<int32_t>(isize);
  return true;
}

// Inflate one block (given its BlockInfo) from an in-memory compressed
// buffer holding the whole member.
bool inflate_block(const uint8_t* member, const BlockInfo& bi, uint8_t* dst, std::string* err) {
  uint16_t xlen;
  memcpy(&xlen, member + 10, 2);
  const uint8_t* cdata = member + 12 + xlen;
  int clen = bi.csize - 12 - xlen - 8;
  int out_n = 0;
  if (!inflate_raw(cdata, clen, dst, bi.usize, &out_n) || out_n != bi.usize) {
    *err = "BGZF inflate failed";
    return false;
  }
  return true;
}

// Parse aux region for NM (integer) and SA (Z). Returns false on malformed.
bool parse_aux(const uint8_t* p, const uint8_t* endp, int64_t* nm,
               const uint8_t** sa, int* sa_n) {
  *nm = 0;
  *sa = nullptr;
  *sa_n = 0;
  while (p < endp) {
    if (endp - p < 3) return false;
    char t0 = p[0], t1 = p[1];
    uint8_t typ = p[2];
    p += 3;
    bool is_nm = (t0 == 'N' && t1 == 'M');
    switch (typ) {
      case 'A': case 'C':
        if (is_nm) *nm = *p;
        p += 1; break;
      case 'c':
        if (is_nm) *nm = *reinterpret_cast<const int8_t*>(p);
        p += 1; break;
      case 's': { if (is_nm) { int16_t v; memcpy(&v, p, 2); *nm = v; } p += 2; break; }
      case 'S': { if (is_nm) { uint16_t v; memcpy(&v, p, 2); *nm = v; } p += 2; break; }
      case 'i': { if (is_nm) { int32_t v; memcpy(&v, p, 4); *nm = v; } p += 4; break; }
      case 'I': { if (is_nm) { uint32_t v; memcpy(&v, p, 4); *nm = v; } p += 4; break; }
      case 'f': p += 4; break;
      case 'Z': case 'H': {
        const uint8_t* q = p;
        while (q < endp && *q) q++;
        if (t0 == 'S' && t1 == 'A' && typ == 'Z') {
          *sa = p;
          *sa_n = static_cast<int>(q - p);
        }
        p = q + 1;
        break;
      }
      case 'B': {
        if (endp - p < 5) return false;
        uint8_t sub = p[0];
        uint32_t cnt;
        memcpy(&cnt, p + 1, 4);
        int size;
        switch (sub) {
          case 'c': case 'C': size = 1; break;
          case 's': case 'S': size = 2; break;
          case 'i': case 'I': case 'f': size = 4; break;
          default: return false;
        }
        p += 5 + static_cast<int64_t>(cnt) * size;
        break;
      }
      default:
        return false;
    }
  }
  return true;
}

// Inflate members[i], described by infos[i], to out + dst[i] for every
// member of infos, on nt threads: member i on thread i mod nt (nt 1: on
// the calling thread).  On failure *err is the error of the first thread
// that had one.
bool inflate_members(const std::vector<BlockInfo>& infos,
                     const std::vector<std::vector<uint8_t>>& members,
                     const int64_t* dst, uint8_t* out, int nt,
                     std::string* err) {
  const size_t k = infos.size();
  if (nt <= 1) {
    for (size_t i = 0; i < k; i++) {
      if (!inflate_block(members[i].data(), infos[i], out + dst[i], err)) {
        return false;
      }
    }
    return true;
  }
  std::string errs[64];
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++) {
    threads.emplace_back([&, t]() {
      for (size_t i = t; i < k; i += nt) {
        if (!inflate_block(members[i].data(), infos[i], out + dst[i],
                           &errs[t])) {
          return;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < nt; t++) {
    if (!errs[t].empty()) { *err = errs[t]; return false; }
  }
  return true;
}

// ---- BGZF windows: the scan's and the region decodes' one reader --------

// One window of BGZF members read in file order, then inflated back to
// back into `data` after the bytes it keeps from the window before.  The
// member buffers and `data` keep their capacity from window to window.
struct BgzfWindow {
  std::vector<BlockInfo> infos;
  std::vector<std::vector<uint8_t>> members;
  std::vector<int64_t> dst;   // offset of each member's payload in data
  dvec<uint8_t> data;
};

// Read up to W members from *next_c on, none that starts at or past end_c
// but the first.  At the end of the file a scan's window (eof_err null)
// ends cleanly, empty if no member was left; a region decode, which never
// reads past its last member, fails there with eof_err.  A read failure
// after the first member ends the window and goes to *deferred: a region
// decode reports it only if it needs the bytes past the window, the scan
// at once.  Returns false with *err set when no member could be read.
bool read_window(FILE* fp, int64_t* next_c, int64_t end_c, int W,
                 const char* eof_err, BgzfWindow* w, std::string* deferred,
                 std::string* err) {
  w->infos.clear();
  if (static_cast<int>(w->members.size()) < W) w->members.resize(W);
  while (w->infos.empty() ||
         (*next_c < end_c && static_cast<int>(w->infos.size()) < W)) {
    BlockInfo bi;
    std::string e;
    if (!read_block_seq(fp, *next_c, &bi, &w->members[w->infos.size()], &e)) {
      if (e.empty()) {
        if (!eof_err) break;
        e = eof_err;
      }
      if (w->infos.empty()) { *err = e; return false; }
      *deferred = e;
      break;
    }
    *next_c = bi.coffset + bi.csize;
    w->infos.push_back(bi);
  }
  return true;
}

// Inflate the window's members into w->data after its first `keep` bytes,
// on as many of nthreads as the window has members; the payload bytes go
// to *inflated, and to *pooled (when given) if more than one thread ran.
bool inflate_window(BgzfWindow* w, int64_t keep, int nthreads,
                    std::atomic<int64_t>* inflated,
                    std::atomic<int64_t>* pooled, std::string* err) {
  const size_t k = w->infos.size();
  w->dst.resize(k);
  int64_t total = 0;
  for (size_t i = 0; i < k; i++) {
    w->dst[i] = keep + total;
    total += w->infos[i].usize;
  }
  w->data.resize(keep + total);
  const int nt = static_cast<int>(std::min<size_t>(nthreads, k));
  if (!inflate_members(w->infos, w->members, w->dst.data(), w->data.data(),
                       nt, err)) {
    return false;
  }
  inflated->fetch_add(total, std::memory_order_relaxed);
  if (pooled && nt > 1) pooled->fetch_add(total, std::memory_order_relaxed);
  return true;
}

// ---- the scan -----------------------------------------------------------

// Streaming scanner: sliding window of blocks, parallel inflate, sequential
// record parse with carry-over across window boundaries.
struct Scanner {
  BgzfWindow w;                        // w.data: the payload not yet parsed
  // per appended block: (start offset in the global stream, coffset)
  std::vector<int64_t> blk_gstart;
  std::vector<int64_t> blk_coffset;
  std::vector<int32_t> blk_usize;
  int64_t gbase = 0;                   // global stream offset of w.data[0]

  uint64_t voffset_of(int64_t gpos) const {
    // binary search blocks for the block containing gpos
    size_t lo = 0, hi = blk_gstart.size();
    while (hi - lo > 1) {
      size_t mid = (lo + hi) / 2;
      if (blk_gstart[mid] <= gpos) lo = mid; else hi = mid;
    }
    return (static_cast<uint64_t>(blk_coffset[lo]) << 16) |
           static_cast<uint64_t>(gpos - blk_gstart[lo]);
  }

  void drop_consumed(int64_t consumed_gpos) {
    // discard buffer bytes & block entries fully before consumed_gpos
    int64_t drop = consumed_gpos - gbase;
    if (drop <= 0) return;
    w.data.erase(w.data.begin(), w.data.begin() + drop);
    gbase = consumed_gpos;
    size_t k = 0;
    while (k + 1 < blk_gstart.size() && blk_gstart[k + 1] <= gbase) k++;
    if (k > 0) {
      blk_gstart.erase(blk_gstart.begin(), blk_gstart.begin() + k);
      blk_coffset.erase(blk_coffset.begin(), blk_coffset.begin() + k);
      blk_usize.erase(blk_usize.begin(), blk_usize.begin() + k);
    }
  }
};

// Parse one record's fields and write them directly into the final
// structure-of-arrays at global index gidx (disjoint per thread — no
// staging, each output byte written exactly once).  The name/SA blob
// BYTES are copied later (phase 3), once per-window prefix sums fix the
// destination offsets; here only lengths and source offsets are stored:
// name length goes to name_off[gidx + 1], the SA source offset (relative
// to the window buffer) to sa_src[i].
bool parse_record_direct(const uint8_t* base, int64_t off, BamCore* bc,
                         int64_t gidx, int64_t* sa_src, std::string* err) {
  int32_t block_size;
  memcpy(&block_size, base + off, 4);
  const uint8_t* r = base + off + 4;
  int32_t ref_id, pos, l_seq;
  uint16_t n_cigar, flag;
  memcpy(&ref_id, r, 4);
  memcpy(&pos, r + 4, 4);
  uint8_t l_read_name = r[8];
  uint8_t mapq = r[9];
  memcpy(&n_cigar, r + 12, 2);
  memcpy(&flag, r + 14, 2);
  memcpy(&l_seq, r + 16, 4);
  const uint8_t* name_p = r + 32;
  const uint8_t* cig_p = name_p + l_read_name;
  // the aligned-base count and the largest gap between aligned blocks:
  // walk_aligned_blocks's blocks, walked inline in the scan's inner loop,
  // each gap measured by block_gap as bc_del_gaps measures it
  int64_t ref_len = 0;
  int64_t aligned = 0, max_gap = 0, prev_blk_end = -1;
  for (int ci = 0; ci < n_cigar; ci++) {
    uint32_t c;
    memcpy(&c, cig_p + 4 * ci, 4);
    if ((1u << (c & 0xF)) & kAligned) {
      const int64_t bstart = pos + ref_len;
      if (prev_blk_end >= 0) {
        max_gap = std::max(max_gap, block_gap(prev_blk_end, bstart));
      }
      prev_blk_end = bstart + (c >> 4);
      aligned += c >> 4;
    }
    if ((1u << (c & 0xF)) & kRefConsuming) ref_len += c >> 4;
  }
  const uint8_t* aux_p = cig_p + 4 * n_cigar + (l_seq + 1) / 2 + l_seq;
  const uint8_t* aux_end = r + block_size;
  int64_t nmv = 0;
  const uint8_t* sa = nullptr;
  int sa_n = 0;
  if (!parse_aux(aux_p, aux_end, &nmv, &sa, &sa_n)) {
    *err = "malformed aux data";
    return false;
  }
  bc->flag[gidx] = flag;
  bc->ref_id[gidx] = ref_id;
  bc->pos[gidx] = pos;
  bc->end[gidx] = pos + ref_len;
  bc->mapq[gidx] = mapq;
  bc->qlen[gidx] = l_seq;
  bc->nm[gidx] = nmv;
  bc->aligned[gidx] = aligned;
  bc->max_gap[gidx] = max_gap;
  bc->name_off[gidx + 1] = l_read_name - 1;   // length; prefix-summed later
  bc->sa_len[gidx] = sa_n;
  *sa_src = sa ? sa - base : -1;
  return true;
}

bool scan_file(BamCore* bc) {
  FILE* fp = bc->fp;
  fseek(fp, 0, SEEK_SET);
  Scanner sc;
  // bc->nthreads is at most 64, the size of the errs arrays below
  const int nthreads = bc->nthreads;

  // Window loop: read W members, inflate them in parallel after the bytes
  // not yet parsed, then parse as many whole records as the buffer allows.
  const int W = 256;
  std::vector<int64_t> sa_src;   // per-window SA source offsets (scratch)
  int64_t coffset = 0;
  bool header_parsed = false;
  int64_t parse_gpos = 0;   // global position of next unparsed byte
  bc->name_off.push_back(0);

  auto append_window = [&]() -> bool {
    std::string deferred;
    if (!read_window(fp, &coffset, std::numeric_limits<int64_t>::max(), W,
                     nullptr, &sc.w, &deferred, &bc->error)) {
      return false;
    }
    if (!deferred.empty()) { bc->error = deferred; return false; }
    if (!inflate_window(&sc.w, sc.w.data.size(), nthreads, &g_scan_inflated,
                        nullptr, &bc->error)) {
      return false;
    }
    for (size_t i = 0; i < sc.w.infos.size(); i++) {
      sc.blk_gstart.push_back(sc.gbase + sc.w.dst[i]);
      sc.blk_coffset.push_back(sc.w.infos[i].coffset);
      sc.blk_usize.push_back(sc.w.infos[i].usize);
    }
    return true;
  };

  dvec<uint8_t>& buf = sc.w.data;
  while (true) {
    size_t before = buf.size();
    if (!append_window()) return false;
    if (buf.size() == before) break;  // EOF

    // parse BAM header once
    if (!header_parsed) {
      if (buf.size() < 12) continue;
      if (memcmp(buf.data(), "BAM\x01", 4) != 0) {
        bc->error = "not a BAM file";
        return false;
      }
      int32_t l_text;
      memcpy(&l_text, buf.data() + 4, 4);
      int64_t need = 8 + static_cast<int64_t>(l_text) + 4;
      if (static_cast<int64_t>(buf.size()) < need) continue;
      int32_t n_ref;
      memcpy(&n_ref, buf.data() + 8 + l_text, 4);
      int64_t p = 12 + l_text;
      bool ok = true;
      for (int i = 0; i < n_ref; i++) {
        if (p + 4 > static_cast<int64_t>(buf.size())) { ok = false; break; }
        int32_t l_name;
        memcpy(&l_name, buf.data() + p, 4);
        if (p + 8 + l_name > static_cast<int64_t>(buf.size())) { ok = false; break; }
        bc->ref_names.emplace_back(reinterpret_cast<char*>(buf.data() + p + 4), l_name - 1);
        int32_t l_ref;
        memcpy(&l_ref, buf.data() + p + 4 + l_name, 4);
        bc->ref_lens.push_back(l_ref);
        p += 8 + l_name;
      }
      if (!ok) {  // header spans beyond current window; extremely rare
        bc->ref_names.clear();
        bc->ref_lens.clear();
        continue;
      }
      header_parsed = true;
      parse_gpos = p;
    }

    // phase 1: cheap boundary discovery over the buffered region
    std::vector<int64_t> rec_offs;
    std::vector<uint64_t> rec_voffs;
    while (true) {
      int64_t off = parse_gpos - sc.gbase;
      if (off + 4 > static_cast<int64_t>(buf.size())) break;
      int32_t block_size;
      memcpy(&block_size, buf.data() + off, 4);
      // BAM fixed fields alone are 32 bytes; a smaller (or negative)
      // block_size is corruption — without this check a negative value
      // loops forever or walks the cursor out of the buffer
      if (block_size < 32) {
        bc->error = "corrupt BAM: record block_size < 32";
        return false;
      }
      if (off + 4 + block_size > static_cast<int64_t>(buf.size())) break;
      rec_offs.push_back(off);
      rec_voffs.push_back(sc.voffset_of(parse_gpos));
      parse_gpos += 4 + block_size;
    }

    // phase 2: parallel field extraction, written DIRECTLY into the
    // final structure-of-arrays (disjoint global indices per thread; no
    // staging, no zero-fill — every output byte is touched exactly once)
    if (!rec_offs.empty()) {
      size_t n = rec_offs.size();
      int64_t gbase_idx = static_cast<int64_t>(bc->flag.size());
      int64_t new_n = gbase_idx + static_cast<int64_t>(n);
      ensure_size(bc->flag, new_n);
      ensure_size(bc->ref_id, new_n);
      ensure_size(bc->pos, new_n);
      ensure_size(bc->end, new_n);
      ensure_size(bc->mapq, new_n);
      ensure_size(bc->qlen, new_n);
      ensure_size(bc->nm, new_n);
      ensure_size(bc->voffset, new_n);
      ensure_size(bc->name_off, new_n + 1);
      ensure_size(bc->sa_len, new_n);
      ensure_size(bc->sa_off, new_n);
      ensure_size(bc->aligned, new_n);
      ensure_size(bc->max_gap, new_n);
      sa_src.resize(n);
      int nt = nthreads;
      if (nt > static_cast<int>(n)) nt = 1;
      std::vector<std::thread> workers;
      std::string errs[64];
      size_t chunk = (n + nt - 1) / nt;
      const uint8_t* base = buf.data();
      for (int t = 0; t < nt; t++) {
        workers.emplace_back([&, t]() {
          size_t lo = t * chunk;
          size_t hi = std::min(lo + chunk, n);
          for (size_t i = lo; i < hi; i++) {
            int64_t g = gbase_idx + static_cast<int64_t>(i);
            bc->voffset[g] = rec_voffs[i];
            if (!parse_record_direct(base, rec_offs[i], bc, g, &sa_src[i],
                                     &errs[t])) {
              return;
            }
          }
        });
      }
      for (auto& w : workers) w.join();
      for (int t = 0; t < nt; t++) {
        if (!errs[t].empty()) { bc->error = errs[t]; return false; }
      }
      // phase 3: prefix-sum the blob offsets for this window, grow the
      // blobs, then copy name/SA bytes in parallel straight from the
      // inflated window buffer
      int64_t name_base = static_cast<int64_t>(bc->name_blob.size());
      int64_t sa_base = static_cast<int64_t>(bc->sa_blob.size());
      int64_t nacc = name_base, sacc = sa_base;
      for (size_t i = 0; i < n; i++) {
        int64_t g = gbase_idx + static_cast<int64_t>(i);
        int64_t nlen = bc->name_off[g + 1];
        int64_t slen = bc->sa_len[g];
        bc->sa_off[g] = slen > 0 ? sacc : 0;
        sacc += slen;
        nacc += nlen;
        bc->name_off[g + 1] = nacc;
      }
      ensure_size(bc->name_blob, static_cast<size_t>(nacc));
      ensure_size(bc->sa_blob, static_cast<size_t>(sacc));
      uint8_t* name_dst = bc->name_blob.data();
      uint8_t* sa_dst = bc->sa_blob.data();
      std::vector<std::thread> copiers;
      for (int t = 0; t < nt; t++) {
        copiers.emplace_back([&, t]() {
          size_t lo = t * chunk;
          size_t hi = std::min(lo + chunk, n);
          for (size_t i = lo; i < hi; i++) {
            int64_t g = gbase_idx + static_cast<int64_t>(i);
            memcpy(name_dst + bc->name_off[g],
                   base + rec_offs[i] + 36,
                   bc->name_off[g + 1] - bc->name_off[g]);
            if (bc->sa_len[g] > 0) {
              memcpy(sa_dst + bc->sa_off[g], base + sa_src[i],
                     bc->sa_len[g]);
            }
          }
        });
      }
      for (auto& c : copiers) c.join();
    }
    sc.drop_consumed(parse_gpos);
  }
  // loud EOF validation (matching the python backend): a file with no
  // BAM header, or trailing unparsed payload bytes (truncation at a
  // block boundary mid-record), must not silently yield a partial table
  if (!header_parsed) {
    bc->error = "not a BAM file (missing BAM\\1 header)";
    return false;
  }
  if (parse_gpos - sc.gbase <
      static_cast<int64_t>(buf.size())) {
    bc->error = "truncated BAM: partial record at end of file";
    return false;
  }
  return true;
}

// ---- region decode ------------------------------------------------------

// Callback-driven decode of records [lo, hi) using stored voffsets.
// The members from the one that holds record lo's first byte to the one
// that holds record hi-1's last byte are read in windows of 16 per thread
// of the handle (at most 256) and inflated a window at a time; the calling
// thread walks each window's records in record order, and the head of a
// record split across windows moves to the front of the next.  No window
// reaches past that last member, so a decode inflates the same members as
// one that reads a member whenever the walk needs more bytes.  Every
// record of the range counts as walked.
template <typename F>
bool decode_range(BamCore* bc, int64_t lo, int64_t hi, F&& fn) {
  if (lo >= hi) return true;
  g_decode_walked.fetch_add(hi - lo, std::memory_order_relaxed);
  FILE* fp = bc->fp;
  int64_t next_c = static_cast<int64_t>(bc->voffset[lo] >> 16);
  int64_t pos = static_cast<int64_t>(bc->voffset[lo] & 0xFFFF);
  // members that start below end_c hold bytes of records [lo, hi): up to
  // the member of voffset[hi] if record hi starts inside it, else the ones
  // before it; after the last record, the rest of the file
  int64_t end_c;
  if (hi < static_cast<int64_t>(bc->voffset.size())) {
    const uint64_t v = bc->voffset[hi];
    end_c = static_cast<int64_t>(v >> 16) + ((v & 0xFFFF) ? 1 : 0);
  } else {
    struct stat st;
    end_c = fstat(fileno(fp), &st) == 0 ? static_cast<int64_t>(st.st_size)
                                        : std::numeric_limits<int64_t>::max();
  }
  const int W = std::min(256, 16 * bc->nthreads);
  BgzfWindow w;
  std::string deferred;
  int64_t keep = 0;   // bytes of the window before its members' payload
  fseek(fp, next_c, SEEK_SET);
  auto next_window = [&]() -> bool {
    if (!deferred.empty()) { bc->error = deferred; return false; }
    return read_window(fp, &next_c, end_c, W,
                       "unexpected EOF in region decode", &w, &deferred,
                       &bc->error) &&
           inflate_window(&w, keep, bc->nthreads, &g_decode_inflated,
                          &g_decode_pooled, &bc->error);
  };
  if (!next_window()) return false;
  for (int64_t i = lo; i < hi; i++) {
    int32_t block_size;
    while (true) {
      const int64_t left = static_cast<int64_t>(w.data.size()) - pos;
      if (left >= 4) {
        memcpy(&block_size, w.data.data() + pos, 4);
        if (left >= 4 + static_cast<int64_t>(block_size)) break;
      }
      // this window ends inside record i: its head opens the next window
      keep = left;
      memmove(w.data.data(), w.data.data() + pos, keep);
      pos = 0;
      if (!next_window()) return false;
    }
    fn(i, w.data.data() + pos + 4, block_size);
    pos += 4 + block_size;
  }
  return true;
}

// Walk the records i of [lo, hi) for which walk(i) holds: decode_range
// over each maximal run of them, fn called for those records alone.  A run
// that starts in the member where the run before it ends joins it, so no
// member is inflated twice in one call; the records between the two are
// walked and skipped.  The other records are answered from the columns.
template <typename P, typename F>
bool decode_where(BamCore* bc, int64_t lo, int64_t hi, P&& walk, F&& fn) {
  auto walk_only = [&](int64_t i, const uint8_t* r, int32_t bsz) {
    if (walk(i)) fn(i, r, bsz);
  };
  int64_t a = -1, b = -1, walked = 0;   // the run [a, b) not yet decoded
  // record i joins the run if it follows it or starts in the run's last
  // member: the one record b starts in, unless b starts at its first byte
  auto joins = [&](int64_t i) {
    const uint64_t vb = bc->voffset[b];
    return i == b ||
           ((vb & 0xFFFF) != 0 && bc->voffset[i] >> 16 == vb >> 16);
  };
  auto flush = [&]() {
    walked += b - a;
    return decode_range(bc, a, b, walk_only);
  };
  bool ok = true;
  for (int64_t i = lo; i < hi && ok; i++) {
    if (!walk(i)) continue;
    if (a >= 0 && joins(i)) {
      b = i + 1;
      continue;
    }
    if (a >= 0) ok = flush();
    a = i;
    b = i + 1;
  }
  if (ok && a >= 0) ok = flush();
  g_decode_column.fetch_add(hi - lo - walked, std::memory_order_relaxed);
  return ok;
}

// A record that counts toward the coverage of a region that starts at
// start: it ends past start and passes the flag and mapping-quality gates.
bool counts_toward(const BamCore* bc, int64_t i, int64_t start,
                   int flag_exclude, int min_mapq) {
  return bc->end[i] > start && !(bc->flag[i] & flag_exclude) &&
         bc->mapq[i] >= min_mapq;
}

// Call fn(a, b) for the bases [a, b) of record i (body r) in [start, stop)
// that count toward coverage: each aligned block clipped to the region,
// or, under a quality threshold where the record stores qualities, each
// base at or above it on its own.
template <typename F>
void covered_bases(const BamCore* bc, int64_t i, const uint8_t* r,
                   int64_t start, int64_t stop, int qual_threshold, F&& fn) {
  uint16_t n_cigar;
  memcpy(&n_cigar, r + 12, 2);
  int32_t l_seq;
  memcpy(&l_seq, r + 16, 4);
  const uint8_t* cig = r + 32 + r[8];
  const uint8_t* qual = cig + 4 * n_cigar + (l_seq + 1) / 2;
  const bool gated = qual_threshold > 0 && l_seq > 0 && qual[0] != 0xFF;
  walk_aligned_blocks(
      cig, n_cigar, bc->pos[i],
      [&](int64_t rstart, int64_t rend, int64_t qoff, int64_t) {
        const int64_t a = std::max(rstart, start), b = std::min(rend, stop);
        if (!gated) {
          if (b > a) fn(a, b);
          return;
        }
        for (int64_t k = a; k < b; k++) {
          if (qual[qoff + (k - rstart)] >= qual_threshold) fn(k, k + 1);
        }
      });
}

// ---- SA-tag chimera assembly --------------------------------------------

// Generic CIGAR span decode over an SA-tag cigar string:
// (left_clip, ref_span, right_clip); returns false if no S or no M.
bool sa_cigar_spans(const char* s, const char* end,
                    int64_t* left, int64_t* ref, int64_t* right) {
  *left = *ref = *right = 0;
  bool seen_core = false, has_s = false, has_m = false;
  int64_t n = 0;
  for (const char* p = s; p < end; p++) {
    char c = *p;
    if (c >= '0' && c <= '9') {
      n = n * 10 + (c - '0');
      continue;
    }
    switch (c) {
      case 'S': case 'H':
        has_s = has_s || (c == 'S');
        if (seen_core) *right += n; else *left += n;
        break;
      case 'M': case '=': case 'X':
        has_m = has_m || (c == 'M');
        seen_core = true;
        *ref += n;
        break;
      case 'D': case 'N':
        seen_core = true;
        *ref += n;
        break;
      case 'I':
        seen_core = true;
        break;
      default:
        return false;
    }
    n = 0;
  }
  return has_s && has_m;
}

struct SaView {
  const char* p;
  size_t n;
  bool operator==(const SaView& o) const {
    return n == o.n && memcmp(p, o.p, n) == 0;
  }
};

bool parse_sa_entry(const char* s, const char* end,
                    int64_t read_length,
                    const std::unordered_map<std::string, int32_t>& ref_ids,
                    ChimAln* out) {
  // fields: rname,pos,strand,cigar,mapQ,NM
  const char* f[6];
  int nf = 0;
  f[nf++] = s;
  for (const char* p = s; p < end && nf < 6; p++) {
    if (*p == ',') f[nf++] = p + 1;
  }
  if (nf < 6) return false;
  std::string rname(f[0], f[1] - 1 - f[0]);
  auto it = ref_ids.find(rname);
  int32_t rid = (it == ref_ids.end()) ? -1 : it->second;
  int64_t pos1 = strtoll(f[1], nullptr, 10);
  char strand = *f[2];
  int64_t left, al, right;
  if (!sa_cigar_spans(f[3], f[4] - 1, &left, &al, &right)) return false;
  int64_t mapq = strtoll(f[4], nullptr, 10);  // bounded by the ',' at f[5]-1
  // the NM field is the LAST in the entry: strtod directly on the blob
  // pointer would run past `end` when a nonconforming SA tag lacks its
  // trailing ';' (OOB read at the blob end; silent digit concatenation
  // from the next entry mid-blob) — copy the bounded span first
  std::string nm_str(f[5], end - f[5]);
  double nm = strtod(nm_str.c_str(), nullptr);
  if (strand == '+') {
    out->qs = left;
    out->qe = read_length - right - 1;
    out->r1 = pos1 - 1;
    out->r2 = pos1 + al - 2;
    out->strand = 1;
  } else {
    out->qs = right;
    out->qe = read_length - left - 1;
    out->r1 = pos1 + al - 2;
    out->r2 = pos1 - 1;
    out->strand = -1;
  }
  out->ref_id = rid;
  out->mapq = static_cast<int32_t>(mapq);
  out->nm = nm;
  return true;
}

// ---- scan cache: persist the record table for instant re-open ----------
// Format: magic, version, source BAM (size, mtime), references, then the
// raw column vectors.  Validity is keyed on the BAM's (size, mtime): any
// change invalidates the cache and a full scan runs instead.

constexpr uint32_t BCX_MAGIC = 0x31584342;  // "BCX1"
constexpr uint32_t BCX_VERSION = 3;

template <typename T>
bool write_vec(FILE* f, const dvec<T>& v) {
  uint64_t n = v.size();
  if (fwrite(&n, 8, 1, f) != 1) return false;
  return n == 0 || fwrite(v.data(), sizeof(T), n, f) == n;
}

template <typename T>
bool read_vec(FILE* f, dvec<T>& v, int64_t max_bytes) {
  uint64_t n = 0;
  if (fread(&n, 8, 1, f) != 1) return false;
  // a corrupt on-disk count must fail the load (-> rescan fallback);
  // without this bound a flipped length field throws bad_alloc through
  // the C ABI and std::terminate()s the host process.  The cache file
  // size caps every vector's payload.
  if (max_bytes < 0 ||
      n > static_cast<uint64_t>(max_bytes) / sizeof(T)) return false;
  ensure_size(v, n);
  v.resize(n);
  return n == 0 || fread(v.data(), sizeof(T), n, f) == n;
}

bool stat_file(const std::string& path, int64_t* size, int64_t* mtime_ns,
               int64_t* ino) {
  struct stat st;
  if (stat(path.c_str(), &st) != 0) return false;
  *size = static_cast<int64_t>(st.st_size);
  // nanosecond mtime + inode: whole-second mtime alone leaves a window
  // where a same-size rewrite within one second serves a stale table
  *mtime_ns = static_cast<int64_t>(st.st_mtim.tv_sec) * 1000000000
            + static_cast<int64_t>(st.st_mtim.tv_nsec);
  *ino = static_cast<int64_t>(st.st_ino);
  return true;
}

bool save_cache(BamCore* bc, const char* cache_path) {
  int64_t size, mtime_ns, ino;
  if (!stat_file(bc->path, &size, &mtime_ns, &ino)) return false;
  FILE* f = fopen(cache_path, "wb");
  if (!f) return false;
  bool ok = true;
  uint32_t hdr[2] = {BCX_MAGIC, BCX_VERSION};
  ok = ok && fwrite(hdr, 4, 2, f) == 2;
  ok = ok && fwrite(&size, 8, 1, f) == 1 && fwrite(&mtime_ns, 8, 1, f) == 1
     && fwrite(&ino, 8, 1, f) == 1;
  uint64_t n_ref = bc->ref_names.size();
  ok = ok && fwrite(&n_ref, 8, 1, f) == 1;
  for (size_t i = 0; ok && i < bc->ref_names.size(); i++) {
    uint64_t ln = bc->ref_names[i].size();
    ok = fwrite(&ln, 8, 1, f) == 1 &&
         (ln == 0 || fwrite(bc->ref_names[i].data(), 1, ln, f) == ln) &&
         fwrite(&bc->ref_lens[i], 8, 1, f) == 1;
  }
  ok = ok && write_vec(f, bc->flag) && write_vec(f, bc->ref_id) &&
       write_vec(f, bc->pos) && write_vec(f, bc->end) &&
       write_vec(f, bc->mapq) && write_vec(f, bc->qlen) &&
       write_vec(f, bc->nm) && write_vec(f, bc->voffset) &&
       write_vec(f, bc->name_blob) && write_vec(f, bc->name_off) &&
       write_vec(f, bc->sa_blob) && write_vec(f, bc->sa_off) &&
       write_vec(f, bc->sa_len) && write_vec(f, bc->aligned) &&
       write_vec(f, bc->max_gap);
  fclose(f);
  if (!ok) remove(cache_path);
  return ok;
}

bool load_cache(BamCore* bc, const char* cache_path) {
  int64_t size, mtime_ns, ino;
  if (!stat_file(bc->path, &size, &mtime_ns, &ino)) return false;
  int64_t cache_bytes, cache_mt, cache_ino;
  if (!stat_file(cache_path, &cache_bytes, &cache_mt, &cache_ino))
    return false;
  FILE* f = fopen(cache_path, "rb");
  if (!f) return false;
  bool ok = true;
  uint32_t hdr[2];
  int64_t csize, cmtime, cino;
  ok = fread(hdr, 4, 2, f) == 2 && hdr[0] == BCX_MAGIC &&
       hdr[1] == BCX_VERSION;
  ok = ok && fread(&csize, 8, 1, f) == 1 && fread(&cmtime, 8, 1, f) == 1 &&
       fread(&cino, 8, 1, f) == 1 &&
       csize == size && cmtime == mtime_ns && cino == ino;
  uint64_t n_ref = 0;
  ok = ok && fread(&n_ref, 8, 1, f) == 1 && n_ref < (1u << 20);
  for (uint64_t i = 0; ok && i < n_ref; i++) {
    uint64_t ln = 0;
    ok = fread(&ln, 8, 1, f) == 1 && ln < (1u << 16);
    if (ok) {
      std::string name(ln, '\0');
      int64_t rlen = 0;
      ok = (ln == 0 || fread(&name[0], 1, ln, f) == ln) &&
           fread(&rlen, 8, 1, f) == 1;
      if (ok) {
        bc->ref_names.push_back(std::move(name));
        bc->ref_lens.push_back(rlen);
      }
    }
  }
  const int64_t mb = cache_bytes;
  ok = ok && read_vec(f, bc->flag, mb) && read_vec(f, bc->ref_id, mb) &&
       read_vec(f, bc->pos, mb) && read_vec(f, bc->end, mb) &&
       read_vec(f, bc->mapq, mb) && read_vec(f, bc->qlen, mb) &&
       read_vec(f, bc->nm, mb) && read_vec(f, bc->voffset, mb) &&
       read_vec(f, bc->name_blob, mb) && read_vec(f, bc->name_off, mb) &&
       read_vec(f, bc->sa_blob, mb) && read_vec(f, bc->sa_off, mb) &&
       read_vec(f, bc->sa_len, mb) && read_vec(f, bc->aligned, mb) &&
       read_vec(f, bc->max_gap, mb);
  ok = ok && bc->name_off.size() == bc->flag.size() + 1 &&
       bc->sa_off.size() == bc->flag.size() &&
       bc->sa_len.size() == bc->flag.size() &&
       bc->aligned.size() == bc->flag.size() &&
       bc->max_gap.size() == bc->flag.size();
  fclose(f);
  if (!ok) {
    // clear EVERYTHING a partial load may have filled: the fallback scan
    // grows the column vectors with ensure_size and would append to any
    // residue, silently doubling the table
    bc->ref_names.clear();
    bc->ref_lens.clear();
    bc->flag.clear();
    bc->ref_id.clear();
    bc->pos.clear();
    bc->end.clear();
    bc->mapq.clear();
    bc->qlen.clear();
    bc->nm.clear();
    bc->voffset.clear();
    bc->name_blob.clear();
    bc->name_off.clear();
    bc->sa_blob.clear();
    bc->sa_off.clear();
    bc->sa_len.clear();
    bc->aligned.clear();
    bc->max_gap.clear();
  }
  return ok;
}

// A handle on path with its thread count and its file open, or with its
// error set.
BamCore* open_handle(const char* path, int nthreads) {
  auto* bc = new BamCore();
  bc->path = path;
  bc->nthreads = nthreads < 1 ? 1 : (nthreads > 64 ? 64 : nthreads);
  bc->fp = fopen(path, "rb");
  if (!bc->fp) bc->error = "cannot open file";
  return bc;
}

bool scan(BamCore* bc) {
  if (scan_file(bc)) return true;
  if (bc->error.empty()) bc->error = "scan failed";
  return false;
}

// Run fn(lo, hi) over [0, n) in contiguous chunks, one a thread, on at
// most nthreads threads (one: on the calling thread).
template <typename F>
void run_chunks(int64_t n, int nthreads, F&& fn) {
  if (n <= 0) return;
  const int nt = static_cast<int>(
      std::min<int64_t>(nthreads < 1 ? 1 : (nthreads > 64 ? 64 : nthreads), n));
  if (nt <= 1) {
    fn(int64_t{0}, n);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n + nt - 1) / nt;
  for (int64_t lo = 0; lo < n; lo += chunk) {
    threads.emplace_back(fn, lo, std::min(lo + chunk, n));
  }
  for (auto& th : threads) th.join();
}

// For each of n_aln alignments, the first interval of the table (ic, is,
// ie; n_int rows, in storage order) that it overlaps on its chromosome,
// or -1.
std::vector<int32_t> first_overlaps(int64_t n_aln, const int32_t* chrom,
                                    const int64_t* r1, const int64_t* r2,
                                    int32_t n_int, const int32_t* ic,
                                    const int64_t* is, const int64_t* ie,
                                    int nthreads) {
  std::vector<int32_t> io(static_cast<size_t>(n_aln > 0 ? n_aln : 1), -1);
  run_chunks(n_aln, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; k++) {
      for (int32_t l = 0; l < n_int; l++) {
        if (chrom[k] == ic[l] && r1[k] <= ie[l] && is[l] <= r2[k]) {
          io[k] = l;
          break;
        }
      }
    }
  });
  return io;
}

}  // namespace

extern "C" {

BamCore* bc_open(const char* path, int nthreads) {
  BamCore* bc = open_handle(path, nthreads);
  if (bc->fp) scan(bc);
  return bc;
}

// Open with a scan cache: load the record table from cache_path when it
// matches the BAM's (size, mtime); otherwise scan and write the cache.
// The BGZF file stays open either way (region re-decode reads it).
BamCore* bc_open_cached(const char* path, const char* cache_path,
                        int nthreads) {
  BamCore* bc = open_handle(path, nthreads);
  if (!bc->fp) return bc;
  if (load_cache(bc, cache_path)) {
    bc->from_cache = true;
  } else if (scan(bc)) {
    save_cache(bc, cache_path);
  }
  return bc;
}

int32_t bc_from_cache(BamCore* bc) { return bc->from_cache ? 1 : 0; }

// The process-wide counters, in this order: scan_inflated_bytes,
// decode_inflated_bytes, decode_pooled_bytes, decode_column_records,
// decode_walked_records.  Writes the first min(n, 5) into out and returns
// how many there are.
int bc_counters(int64_t* out, int n) {
  const int64_t v[5] = {g_scan_inflated.load(std::memory_order_relaxed),
                        g_decode_inflated.load(std::memory_order_relaxed),
                        g_decode_pooled.load(std::memory_order_relaxed),
                        g_decode_column.load(std::memory_order_relaxed),
                        g_decode_walked.load(std::memory_order_relaxed)};
  for (int i = 0; i < n && i < 5; i++) out[i] = v[i];
  return 5;
}

void bc_close(BamCore* bc) { delete bc; }
const char* bc_error(BamCore* bc) { return bc->error.empty() ? nullptr : bc->error.c_str(); }
int64_t bc_nrecords(BamCore* bc) { return static_cast<int64_t>(bc->flag.size()); }
int32_t bc_nrefs(BamCore* bc) { return static_cast<int32_t>(bc->ref_names.size()); }
const char* bc_ref_name(BamCore* bc, int32_t i) { return bc->ref_names[i].c_str(); }
int64_t bc_ref_len(BamCore* bc, int32_t i) { return bc->ref_lens[i]; }

const uint16_t* bc_col_flag(BamCore* bc) { return bc->flag.data(); }
const int32_t* bc_col_ref(BamCore* bc) { return bc->ref_id.data(); }
const int64_t* bc_col_pos(BamCore* bc) { return bc->pos.data(); }
const int64_t* bc_col_end(BamCore* bc) { return bc->end.data(); }
const uint8_t* bc_col_mapq(BamCore* bc) { return bc->mapq.data(); }
const int32_t* bc_col_qlen(BamCore* bc) { return bc->qlen.data(); }
const int64_t* bc_col_nm(BamCore* bc) { return bc->nm.data(); }
const int64_t* bc_col_aligned(BamCore* bc) { return bc->aligned.data(); }
const int64_t* bc_col_max_gap(BamCore* bc) { return bc->max_gap.data(); }
const uint8_t* bc_name_blob(BamCore* bc) { return bc->name_blob.data(); }
int64_t bc_name_blob_len(BamCore* bc) { return static_cast<int64_t>(bc->name_blob.size()); }
const int64_t* bc_name_off(BamCore* bc) { return bc->name_off.data(); }
const uint8_t* bc_sa_blob(BamCore* bc) { return bc->sa_blob.data(); }
int64_t bc_sa_blob_len(BamCore* bc) { return static_cast<int64_t>(bc->sa_blob.size()); }
const int64_t* bc_sa_off(BamCore* bc) { return bc->sa_off.data(); }
const int64_t* bc_sa_len(BamCore* bc) { return bc->sa_len.data(); }

// Open-addressing name->slot table (FNV-1a, linear probing, pow2 cap
// >= 2x the worst-case key count so the load factor stays <= 0.5, no
// growth path needed): one flat array, no allocation a key.  Keys are
// views into the stable name blob, so entries store raw (ptr, len).
struct NameSlotTable {
  struct Entry { const char* p; uint32_t len; int32_t slot; };
  std::vector<Entry> tab;
  size_t mask = 0;
  void init(size_t expect) {
    size_t cap = 16;
    while (cap < (expect + 1) * 2) cap <<= 1;
    tab.assign(cap, Entry{nullptr, 0, -1});
    mask = cap - 1;
  }
  static uint64_t hash(const char* p, size_t n) {
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < n; i++) {
      h ^= static_cast<unsigned char>(p[i]);
      h *= 1099511628211ull;
    }
    return h;
  }
  // slot pointer for nm; *result == -1 means freshly inserted (caller
  // assigns the slot; real slots are always >= 0)
  int32_t* probe(std::string_view nm) {
    size_t i = hash(nm.data(), nm.size()) & mask;
    while (tab[i].p) {
      if (tab[i].len == nm.size()
          && memcmp(tab[i].p, nm.data(), nm.size()) == 0) {
        return &tab[i].slot;
      }
      i = (i + 1) & mask;
    }
    tab[i].p = nm.data();
    tab[i].len = static_cast<uint32_t>(nm.size());
    tab[i].slot = -1;
    return &tab[i].slot;
  }
  // find-only: returns slot or -1
  int32_t find(std::string_view nm) const {
    if (tab.empty()) return -1;
    size_t i = hash(nm.data(), nm.size()) & mask;
    while (tab[i].p) {
      if (tab[i].len == nm.size()
          && memcmp(tab[i].p, nm.data(), nm.size()) == 0) {
        return tab[i].slot;
      }
      i = (i + 1) & mask;
    }
    return -1;
  }
};

int64_t bc_parse_sa(BamCore* bc) {
  // Assemble per-read chimeric alignments from SA tags: union of unique SA
  // entries across all of a read's records (each record lists the others),
  // decoded with the generic CIGAR-span formula and sorted by query start.
  // A read whose SA set contains a clipless/matchless entry keeps an empty
  // alignment list (the reference's ([], [], []) sentinel).
  const int64_t n = static_cast<int64_t>(bc->flag.size());
  std::unordered_map<std::string, int32_t> ref_ids;
  for (size_t i = 0; i < bc->ref_names.size(); i++) {
    ref_ids[bc->ref_names[i]] = static_cast<int32_t>(i);
  }
  // string_view keys into the (stable) name blob: no string a record
  auto name_of = [&](int64_t i) {
    return std::string_view(
        reinterpret_cast<const char*>(bc->name_blob.data()) + bc->name_off[i],
        static_cast<size_t>(bc->name_off[i + 1] - bc->name_off[i]));
  };
  // slot per chimeric read, in first-appearance order.  The SA split +
  // per-read dedup runs threaded over contiguous record ranges into
  // thread-local maps; the sequential merge walks the parts in thread
  // (= record) order, so global first-appearance order, per-read entry
  // order, and dedup-keep-first are all identical to the sequential
  // scan.  A read whose records span ranges gets its parts' buckets
  // concatenated with the same std::find dedup the scan does.
  NameSlotTable slot_of;
  std::vector<int64_t> first_rec;
  std::vector<std::vector<SaView>> sa_sets;
  std::vector<int64_t> read_len;
  int64_t n_sa = 0;
  for (int64_t i = 0; i < n; i++) n_sa += bc->sa_len[i] != 0;
  slot_of.init(static_cast<size_t>(n_sa));
  first_rec.reserve(static_cast<size_t>(n_sa));
  sa_sets.reserve(static_cast<size_t>(n_sa));
  read_len.reserve(static_cast<size_t>(n_sa));
  {
    struct SlotPart {
      NameSlotTable slot_of;
      std::vector<int64_t> first_rec;
      std::vector<std::string_view> names;
      std::vector<std::vector<SaView>> sa_sets;
      std::vector<int64_t> rlen;   // primary qlen seen in-pass (-1 none)
    };
    unsigned hw0 = std::thread::hardware_concurrency();
    int nt0 = static_cast<int>(hw0 ? (hw0 > 8 ? 8 : hw0) : 1);
    if (n_sa < 65536) nt0 = 1;
    std::vector<SlotPart> sparts(nt0);
    const int64_t rchunk = (n + nt0 - 1) / nt0;
    auto swork = [&](int ti) {
      SlotPart& sp = sparts[ti];
      const int64_t r0 = ti * rchunk;
      const int64_t r1 = std::min<int64_t>(n, r0 + rchunk);
      // exact per-part worst case (unique names <= SA records in range)
      // so the open-addressing table never needs to grow
      int64_t part_sa = 0;
      for (int64_t i = r0; i < r1; i++) part_sa += bc->sa_len[i] != 0;
      const size_t cap = static_cast<size_t>(part_sa);
      sp.slot_of.init(cap);
      sp.first_rec.reserve(cap);
      sp.names.reserve(cap);
      sp.sa_sets.reserve(cap);
      sp.rlen.reserve(cap);
      const char* blob = reinterpret_cast<const char*>(bc->sa_blob.data());
      for (int64_t i = r0; i < r1; i++) {
        if (bc->sa_len[i] == 0) continue;
        std::string_view nm = name_of(i);
        int32_t* sl = sp.slot_of.probe(nm);
        int32_t slot;
        if (*sl < 0) {
          slot = static_cast<int32_t>(sp.first_rec.size());
          *sl = slot;
          sp.first_rec.push_back(i);
          sp.names.push_back(nm);
          sp.sa_sets.emplace_back();
          sp.rlen.push_back(-1);
        } else {
          slot = *sl;
        }
        // a read has at most one primary record (flag < 256: secondary
        // 0x100 and supplementary 0x800 both exceed it), so its qlen is
        // taken here when the primary carries the SA tag, as aligners
        // emit for split reads; the whole-BAM pass below runs only for
        // slots left unresolved.  First seen wins within a chunk as the
        // merge does across them, so a BAM with duplicate primary
        // records gives the first in file order at any thread count.
        if (bc->flag[i] < 256 && sp.rlen[slot] < 0) {
          sp.rlen[slot] = bc->qlen[i];
        }
        const char* p = blob + bc->sa_off[i];
        const char* end = p + bc->sa_len[i];
        // split on ';', dropping a trailing empty entry
        while (p < end) {
          const char* q = p;
          while (q < end && *q != ';') q++;
          if (q > p) {
            SaView v{p, static_cast<size_t>(q - p)};
            auto& bucket = sp.sa_sets[slot];
            if (std::find(bucket.begin(), bucket.end(), v) == bucket.end()) {
              bucket.push_back(v);
            }
          }
          p = q + 1;
        }
      }
    };
    if (nt0 == 1) {
      swork(0);
    } else {
      std::vector<std::thread> sthreads;
      for (int ti = 0; ti < nt0; ti++) sthreads.emplace_back(swork, ti);
      for (auto& t : sthreads) t.join();
    }
    int64_t unresolved = 0;
    for (SlotPart& sp : sparts) {
      for (size_t j = 0; j < sp.names.size(); j++) {
        int32_t* sl = slot_of.probe(sp.names[j]);
        int32_t slot;
        if (*sl < 0) {
          slot = static_cast<int32_t>(first_rec.size());
          *sl = slot;
          first_rec.push_back(sp.first_rec[j]);
          sa_sets.emplace_back(std::move(sp.sa_sets[j]));
          read_len.push_back(sp.rlen[j]);
          unresolved += sp.rlen[j] < 0;
          continue;
        }
        slot = *sl;
        if (read_len[slot] < 0 && sp.rlen[j] >= 0) {
          read_len[slot] = sp.rlen[j];
          unresolved--;
        }
        auto& bucket = sa_sets[slot];
        for (const SaView& v : sp.sa_sets[j]) {
          if (std::find(bucket.begin(), bucket.end(), v) == bucket.end()) {
            bucket.push_back(v);
          }
        }
      }
    }
    // fallback for chimeric reads whose primary record carries no SA
    // tag (possible but unusual): only then scan the whole BAM for
    // primaries.  The in-pass capture above resolves everything when
    // primaries carry SA, making this pass free.
    if (unresolved > 0) {
      for (int64_t i = 0; i < n; i++) {
        if (bc->flag[i] >= 256 || bc->sa_len[i] != 0) continue;
        int32_t slot = slot_of.find(name_of(i));
        if (slot >= 0 && read_len[slot] < 0) {
          read_len[slot] = bc->qlen[i];
        }
      }
    }
  }
  // parse + sort + emit, threaded over contiguous slot ranges: each
  // worker fills private column vectors, then a sequential slot-order
  // concatenation reproduces the single-threaded emission byte-for-byte
  // (same per-slot parse, same stable sort, same skip rules).
  const size_t n_slots = first_rec.size();
  struct Part {
    std::vector<int64_t> qs, qe, r1, r2;
    std::vector<int32_t> ref, mapq;
    std::vector<int8_t> strand;
    std::vector<double> nm;
    std::vector<int32_t> cnt;  // alignments emitted per slot in range
  };
  unsigned hw = std::thread::hardware_concurrency();
  int nt = static_cast<int>(hw ? (hw > 8 ? 8 : hw) : 1);
  if (n_slots < 4096) nt = 1;
  std::vector<Part> parts(nt);
  const size_t chunk = (n_slots + nt - 1) / (nt ? nt : 1);
  auto work = [&](int ti) {
    Part& pt = parts[ti];
    const size_t s0 = ti * chunk;
    const size_t s1 = std::min(n_slots, s0 + chunk);
    if (s0 >= s1) return;
    pt.cnt.assign(s1 - s0, 0);
    std::vector<ChimAln> tmp;
    for (size_t s = s0; s < s1; s++) {
      if (read_len[s] < 0) continue;  // no primary alignment: dropped
      tmp.clear();
      bool valid = true;
      for (const SaView& v : sa_sets[s]) {
        ChimAln a;
        if (!parse_sa_entry(v.p, v.p + v.n, read_len[s], ref_ids, &a)) {
          valid = false;
          break;
        }
        tmp.push_back(a);
      }
      if (!valid) continue;  // empty alignment list, slot still emitted
      std::stable_sort(tmp.begin(), tmp.end(),
                       [](const ChimAln& x, const ChimAln& y) {
                         return x.qs != y.qs ? x.qs < y.qs : x.qe < y.qe;
                       });
      pt.cnt[s - s0] = static_cast<int32_t>(tmp.size());
      for (const ChimAln& a : tmp) {
        pt.qs.push_back(a.qs);
        pt.qe.push_back(a.qe);
        pt.r1.push_back(a.r1);
        pt.r2.push_back(a.r2);
        pt.ref.push_back(a.ref_id);
        pt.mapq.push_back(a.mapq);
        pt.strand.push_back(a.strand);
        // degenerate 1-base local alignment: qe == qs (reference
        // off-by-one span; it ZeroDivisionErrors, cigar_parsing.py:268).
        // Emit inf explicitly — a plain 0.0/0.0 is NaN, which would
        // diverge from the python backend's inf for NM=0 records
        pt.nm.push_back(
            a.qe > a.qs ? a.nm / static_cast<double>(a.qe - a.qs)
                        : std::numeric_limits<double>::infinity());
      }
    }
  };
  if (nt == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int ti = 0; ti < nt; ti++) threads.emplace_back(work, ti);
    for (auto& t : threads) t.join();
  }
  bc->chim_rec.clear();
  bc->chim_rl.clear();
  bc->chim_off.assign(1, 0);
  bc->aln_qs.clear(); bc->aln_qe.clear(); bc->aln_r1.clear();
  bc->aln_r2.clear(); bc->aln_ref.clear(); bc->aln_mapq.clear();
  bc->aln_strand.clear(); bc->aln_nm.clear();
  size_t total_aln = 0, total_rec = 0;
  for (const Part& pt : parts) total_aln += pt.qs.size();
  for (size_t s = 0; s < n_slots; s++) total_rec += read_len[s] >= 0;
  bc->aln_qs.reserve(total_aln); bc->aln_qe.reserve(total_aln);
  bc->aln_r1.reserve(total_aln); bc->aln_r2.reserve(total_aln);
  bc->aln_ref.reserve(total_aln); bc->aln_mapq.reserve(total_aln);
  bc->aln_strand.reserve(total_aln); bc->aln_nm.reserve(total_aln);
  bc->chim_rec.reserve(total_rec); bc->chim_rl.reserve(total_rec);
  bc->chim_off.reserve(total_rec + 1);
  for (int ti = 0; ti < nt; ti++) {
    Part& pt = parts[ti];
    const size_t s0 = ti * chunk;
    const size_t s1 = std::min(n_slots, s0 + chunk);
    bc->aln_qs.insert(bc->aln_qs.end(), pt.qs.begin(), pt.qs.end());
    bc->aln_qe.insert(bc->aln_qe.end(), pt.qe.begin(), pt.qe.end());
    bc->aln_r1.insert(bc->aln_r1.end(), pt.r1.begin(), pt.r1.end());
    bc->aln_r2.insert(bc->aln_r2.end(), pt.r2.begin(), pt.r2.end());
    bc->aln_ref.insert(bc->aln_ref.end(), pt.ref.begin(), pt.ref.end());
    bc->aln_mapq.insert(bc->aln_mapq.end(), pt.mapq.begin(), pt.mapq.end());
    bc->aln_strand.insert(bc->aln_strand.end(), pt.strand.begin(),
                          pt.strand.end());
    bc->aln_nm.insert(bc->aln_nm.end(), pt.nm.begin(), pt.nm.end());
    int64_t off = bc->chim_off.back();
    for (size_t s = s0; s < s1; s++) {
      if (read_len[s] < 0) continue;
      bc->chim_rec.push_back(first_rec[s]);
      bc->chim_rl.push_back(static_cast<int32_t>(read_len[s]));
      off += pt.cnt[s - s0];
      bc->chim_off.push_back(off);
    }
  }
  return static_cast<int64_t>(bc->chim_rec.size());
}

const int64_t* bc_chim_rec(BamCore* bc) { return bc->chim_rec.data(); }
const int32_t* bc_chim_rl(BamCore* bc) { return bc->chim_rl.data(); }
const int64_t* bc_chim_off(BamCore* bc) { return bc->chim_off.data(); }
const int64_t* bc_aln_qs(BamCore* bc) { return bc->aln_qs.data(); }
const int64_t* bc_aln_qe(BamCore* bc) { return bc->aln_qe.data(); }
const int64_t* bc_aln_r1(BamCore* bc) { return bc->aln_r1.data(); }
const int64_t* bc_aln_r2(BamCore* bc) { return bc->aln_r2.data(); }
const int32_t* bc_aln_ref(BamCore* bc) { return bc->aln_ref.data(); }
const int32_t* bc_aln_mapq(BamCore* bc) { return bc->aln_mapq.data(); }
const int8_t* bc_aln_strand(BamCore* bc) { return bc->aln_strand.data(); }
const double* bc_aln_nm(BamCore* bc) { return bc->aln_nm.data(); }

int64_t bc_coverage_sum(BamCore* bc, int64_t lo, int64_t hi,
                        int64_t start, int64_t stop,
                        int qual_threshold, int flag_exclude, int min_mapq) {
  // With qual_threshold <= 0 a counted record that lies inside [start,
  // stop) adds its aligned-base count from the scan's column, and only the
  // records that straddle an end are walked; a quality threshold walks
  // them all.
  int64_t total = 0;
  auto counted = [&](int64_t i) {
    return counts_toward(bc, i, start, flag_exclude, min_mapq);
  };
  auto add = [&](int64_t i, const uint8_t* r, int32_t) {
    if (!counted(i)) return;
    covered_bases(bc, i, r, start, stop, qual_threshold,
                  [&](int64_t a, int64_t b) { total += b - a; });
  };
  if (qual_threshold > 0) {
    return decode_range(bc, lo, hi, add) ? total : -1;
  }
  auto inside = [&](int64_t i) {
    return bc->pos[i] >= start && bc->end[i] <= stop;
  };
  for (int64_t i = lo; i < hi; i++) {
    if (counted(i) && inside(i)) total += bc->aligned[i];
  }
  bool ok = decode_where(
      bc, lo, hi, [&](int64_t i) { return counted(i) && !inside(i); }, add);
  return ok ? total : -1;
}

int bc_coverage_profile(BamCore* bc, int64_t lo, int64_t hi,
                        int64_t start, int64_t stop,
                        int qual_threshold, int flag_exclude, int min_mapq,
                        int64_t* out) {
  memset(out, 0, sizeof(int64_t) * (stop - start));
  bool ok = decode_range(bc, lo, hi, [&](int64_t i, const uint8_t* r, int32_t) {
    if (!counts_toward(bc, i, start, flag_exclude, min_mapq)) return;
    covered_bases(bc, i, r, start, stop, qual_threshold,
                  [&](int64_t a, int64_t b) {
                    for (int64_t k = a; k < b; k++) out[k - start]++;
                  });
  });
  return ok ? 0 : -1;
}

int64_t bc_del_gaps(BamCore* bc, int64_t lo, int64_t hi,
                    int64_t start, int64_t min_del_len, int min_mapq) {
  // only a record whose largest gap, kept by the scan, exceeds
  // min_del_len can have a row, so only such records are walked
  bc->gaps.clear();
  auto walk = [&](int64_t i) {
    return bc->end[i] > start && bc->mapq[i] >= min_mapq &&
           bc->max_gap[i] > min_del_len;
  };
  bool ok = decode_where(bc, lo, hi, walk, [&](int64_t i, const uint8_t* r,
                                               int32_t) {
    uint16_t n_cigar;
    memcpy(&n_cigar, r + 12, 2);
    int64_t blk_first = -1, blk_last = -1;
    const size_t first_row = bc->gaps.size();
    walk_aligned_blocks(
        r + 32 + r[8], n_cigar, bc->pos[i],
        [&](int64_t rstart, int64_t rend, int64_t, int64_t prev_end) {
          if (blk_first < 0) blk_first = rstart;
          if (prev_end >= 0 && block_gap(prev_end, rstart) > min_del_len) {
            bc->gaps.push_back({i, rstart, prev_end, 0, 0});
          }
          blk_last = rend;
        });
    for (size_t k = first_row; k < bc->gaps.size(); k++) {
      bc->gaps[k].blk_first = blk_first;
      bc->gaps[k].blk_last = blk_last;
    }
  });
  return ok ? static_cast<int64_t>(bc->gaps.size()) : -1;
}

void bc_del_gaps_fetch(BamCore* bc, int64_t* rec, int64_t* next_start,
                       int64_t* prev_end, int64_t* blk_first, int64_t* blk_last) {
  for (size_t k = 0; k < bc->gaps.size(); k++) {
    rec[k] = bc->gaps[k].rec;
    next_start[k] = bc->gaps[k].next_start;
    prev_end[k] = bc->gaps[k].prev_end;
    blk_first[k] = bc->gaps[k].blk_first;
    blk_last[k] = bc->gaps[k].blk_last;
  }
}

// Pack adjacent-pair predicate columns straight from the flat alignment
// columns into the device layout (ops/scoring.py PACKED_COL_ORDER: qgap,
// r1_i, r2_i, r1_j, r2_j, meta; bit layout per META_* constants there).
// Pair p is (pi[p], pi[p]+1).  Every output byte is written exactly once
// (pads [n_pairs, n_out) zeroed here, so callers pass never-memset
// np.empty buffers — first-touch page cost is paid once, by this pass).
// Semantics are bit-identical to pack_pair_cols(np, ...): int64->int32
// casts wrap, MAPQ clamps to the BAM uint8 domain.
void bc_pack_pairs(int64_t n_pairs, const int64_t* pi,
                   const int64_t* qs, const int64_t* qe,
                   const int64_t* r1, const int64_t* r2,
                   const int32_t* chrom, const int8_t* strand,
                   const int32_t* mapq, int64_t n_out, int nthreads,
                   int32_t* out_qgap, int32_t* out_r1i, int32_t* out_r2i,
                   int32_t* out_r1j, int32_t* out_r2j, int32_t* out_meta) {
  auto side = [&](int64_t k) -> int32_t {
    int32_t mq = mapq[k];
    mq = mq < 0 ? 0 : (mq > 255 ? 255 : mq);
    return ((chrom[k] + 1) << 9) | (mq << 1) | (strand[k] > 0 ? 1 : 0);
  };
  run_chunks(n_out, nthreads, [&](int64_t lo, int64_t hi) {
    int64_t body = hi < n_pairs ? hi : n_pairs;
    for (int64_t p = lo; p < body; p++) {
      int64_t i = pi[p], j = i + 1;
      out_qgap[p] = static_cast<int32_t>(qs[j] - qe[i]);
      out_r1i[p] = static_cast<int32_t>(r1[i]);
      out_r2i[p] = static_cast<int32_t>(r2[i]);
      out_r1j[p] = static_cast<int32_t>(r1[j]);
      out_r2j[p] = static_cast<int32_t>(r2[j]);
      out_meta[p] = (side(i) << 14) | side(j);
    }
    for (int64_t p = body > lo ? body : lo; p < hi; p++) {
      out_qgap[p] = 0;
      out_r1i[p] = 0;
      out_r2i[p] = 0;
      out_r1j[p] = 0;
      out_r2j[p] = 0;
      out_meta[p] = 0;
    }
  });
}

// v2: interval-RESOLVED pack (ops/scoring.py PACKED2_COL_ORDER: qgap,
// r2_i, r1_j, meta; bit layout per META2_* constants there).  The
// first_overlap search runs once per ALIGNMENT (storage-order first
// match — ops/scoring.py first_overlap semantics, including the
// minus-strand symmetric-endpoint quirk carried by the caller's storage
// order), then each pair's meta word gets the combined gate
// iog = io_i if (io_i >= 0 && io_i == io_j) else -1, stored +1 in 13
// bits.  Bit-identical to scoring.pack_pairs2_host by test.  Pads
// [n_pairs, n_out) zero (meta 0 decodes to iog -1: inert).
void bc_pack_pairs2(int64_t n_pairs, const int64_t* pi,
                    const int64_t* qs, const int64_t* qe,
                    const int64_t* r1, const int64_t* r2,
                    const int32_t* chrom, const int8_t* strand,
                    const int32_t* mapq, int64_t n_aln,
                    int32_t n_int, const int32_t* ic, const int64_t* is,
                    const int64_t* ie, int64_t n_out, int nthreads,
                    int32_t* out_qgap, int32_t* out_r2i, int32_t* out_r1j,
                    int32_t* out_meta) {
  const std::vector<int32_t> io = first_overlaps(
      n_aln, chrom, r1, r2, n_int, ic, is, ie, nthreads);
  run_chunks(n_out, nthreads, [&](int64_t lo, int64_t hi) {
    int64_t body = hi < n_pairs ? hi : n_pairs;
    for (int64_t p = lo; p < body; p++) {
      int64_t i = pi[p], j = i + 1;
      int32_t iog = (io[i] >= 0 && io[i] == io[j]) ? io[i] : -1;
      int32_t mi = mapq[i] < 0 ? 0 : (mapq[i] > 255 ? 255 : mapq[i]);
      int32_t mj = mapq[j] < 0 ? 0 : (mapq[j] > 255 ? 255 : mapq[j]);
      out_qgap[p] = static_cast<int32_t>(qs[j] - qe[i]);
      out_r2i[p] = static_cast<int32_t>(r2[i]);
      out_r1j[p] = static_cast<int32_t>(r1[j]);
      out_meta[p] = ((iog + 1) << 18) | (mi << 10) |
                    ((strand[i] > 0 ? 1 : 0) << 9) | (mj << 1) |
                    (strand[j] > 0 ? 1 : 0);
    }
    for (int64_t p = body > lo ? body : lo; p < hi; p++) {
      out_qgap[p] = 0;
      out_r2i[p] = 0;
      out_r1j[p] = 0;
      out_meta[p] = 0;
    }
  });
}

// v3: fully RESOLVED pack (ops/scoring.py PACKED3_COL_ORDER: qgap, grr,
// meta; bit layout per META3_* constants there).  Beyond v2's per-
// alignment interval resolution this folds the per-side MAPQ gate into
// the combined gate (iogm = iog only when both sides pass min_mapq) and
// pre-derives the same-strand clause's reference jump
// grr = (strand_j > 0) ? r1_j - r2_i : r2_i - r1_j — one subtract+select
// per pair, the same class of pack-time arithmetic as qgap.  The device
// kernel then runs only the junction decision chain + histogram over
// 12 B/pair.  Bit-identical to scoring.pack_pairs3_host by test.  Pads
// [n_pairs, n_out) zero (meta 0 decodes to iogm -1: inert).
void bc_pack_pairs3(int64_t n_pairs, const int64_t* pi,
                    const int64_t* qs, const int64_t* qe,
                    const int64_t* r1, const int64_t* r2,
                    const int32_t* chrom, const int8_t* strand,
                    const int32_t* mapq, int64_t n_aln,
                    int32_t n_int, const int32_t* ic, const int64_t* is,
                    const int64_t* ie, int32_t min_mapq,
                    int64_t n_out, int nthreads,
                    int32_t* out_qgap, int32_t* out_grr,
                    int32_t* out_meta) {
  const std::vector<int32_t> io = first_overlaps(
      n_aln, chrom, r1, r2, n_int, ic, is, ie, nthreads);
  run_chunks(n_out, nthreads, [&](int64_t lo, int64_t hi) {
    int64_t body = hi < n_pairs ? hi : n_pairs;
    for (int64_t p = lo; p < body; p++) {
      int64_t i = pi[p], j = i + 1;
      int32_t iog = (io[i] >= 0 && io[i] == io[j]) ? io[i] : -1;
      if (mapq[i] < min_mapq || mapq[j] < min_mapq) iog = -1;
      int32_t r2i = static_cast<int32_t>(r2[i]);
      int32_t r1j = static_cast<int32_t>(r1[j]);
      out_qgap[p] = static_cast<int32_t>(qs[j] - qe[i]);
      out_grr[p] = strand[j] > 0 ? r1j - r2i : r2i - r1j;
      out_meta[p] = ((iog + 1) << 1) |
                    (strand[i] != strand[j] ? 1 : 0);
    }
    for (int64_t p = body > lo ? body : lo; p < hi; p++) {
      out_qgap[p] = 0;
      out_grr[p] = 0;
      out_meta[p] = 0;
    }
  });
}

int64_t bc_cluster_firstfit(int64_t n, const int64_t* p1, const int64_t* p2,
                            int64_t cutoff, int32_t* cluster_out) {
  // Greedy first-fit clustering of one (chr1, chr2, o1, o2) group —
  // the native twin of ops/breakpoints._cluster_group_host (reference
  // ``cluster_bp_list`` semantics): member m joins the FIRST cluster
  // (creation order) containing any member within ``cutoff`` on both
  // coordinates (strict <); otherwise it founds a new cluster.  Same
  // exactness-preserving accelerations as the Python _PosBuffer:
  // bounding-box reject, founder probe, 32-member prefix probe.
  // Returns the cluster count; cluster ids (creation order) land in
  // cluster_out.  Bit-identical assignment to the Python scan
  // (tests/test_bptable.py::test_native_firstfit_matches_python).
  struct Clu {
    std::vector<int64_t> a1, a2;
    int64_t lo1, hi1, lo2, hi2, f1, f2;
  };
  std::vector<Clu> clus;
  for (int64_t m = 0; m < n; m++) {
    const int64_t x1 = p1[m], x2 = p2[m];
    int32_t target = -1;
    for (size_t c = 0; c < clus.size(); c++) {
      Clu& cl = clus[c];
      if (x1 <= cl.lo1 - cutoff || x1 >= cl.hi1 + cutoff ||
          x2 <= cl.lo2 - cutoff || x2 >= cl.hi2 + cutoff) {
        continue;
      }
      const int64_t d1 = x1 - cl.f1, d2 = x2 - cl.f2;
      bool hit = (-cutoff < d1 && d1 < cutoff && -cutoff < d2 && d2 < cutoff);
      if (!hit) {
        const size_t k = cl.a1.size();
        for (size_t i = 0; i < k; i++) {
          const int64_t e1 = x1 - cl.a1[i], e2 = x2 - cl.a2[i];
          if (-cutoff < e1 && e1 < cutoff && -cutoff < e2 && e2 < cutoff) {
            hit = true;
            break;
          }
        }
      }
      if (hit) {
        target = static_cast<int32_t>(c);
        break;
      }
    }
    if (target >= 0) {
      Clu& cl = clus[target];
      cl.a1.push_back(x1);
      cl.a2.push_back(x2);
      if (x1 < cl.lo1) cl.lo1 = x1; else if (x1 > cl.hi1) cl.hi1 = x1;
      if (x2 < cl.lo2) cl.lo2 = x2; else if (x2 > cl.hi2) cl.hi2 = x2;
      cluster_out[m] = target;
    } else {
      cluster_out[m] = static_cast<int32_t>(clus.size());
      clus.emplace_back();
      Clu& cl = clus.back();
      cl.a1.push_back(x1);
      cl.a2.push_back(x2);
      cl.lo1 = cl.hi1 = cl.f1 = x1;
      cl.lo2 = cl.hi2 = cl.f2 = x2;
    }
  }
  return static_cast<int64_t>(clus.size());
}

}  // extern "C"
