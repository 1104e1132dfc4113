// rtc_native — native runtime for the rabbittclust_tpu framework.
//
// Host-side components that are string/IO-bound and therefore belong on the
// CPU, built fresh for this framework (not copied from the reference):
//   * glibc srand()/rand() emulation + the KSSD dimension-shuffle table
//     (behavioral spec: reference src/SketchInfo.cpp:60-102)
//   * KSSD sketcher: rolling 2-bit canonical k-mer scan + dimension filter
//     (behavioral spec: reference src/SketchInfo.cpp:994-1252)
//   * MinHash bottom-s sketcher (Mash-compatible MurmurHash3, seed 42)
//   * Parallel FASTA(.gz) ingest (OpenMP over files / sequences)
//
// Build:  g++ -O3 -march=native -fopenmp -shared -fPIC -o librtc_native.so \
//             rtc_native.cpp -lz
// Python binding: ctypes (see rabbittclust_tpu/utils/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <climits>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include <algorithm>
#include <unordered_map>
#include <zlib.h>
#include <parallel/algorithm>
#include <omp.h>

// ---------------------------------------------------------------------------
// glibc rand() emulation (TYPE_3 additive generator, degree 31, separation 3)
// ---------------------------------------------------------------------------

namespace {

struct GlibcRand {
  uint32_t table[344];
  size_t f, r;  // front (i-3) and rear (i-31) indices into ring
  uint32_t ring[31];
  size_t pos;

  explicit GlibcRand(uint32_t seed) {
    if (seed == 0) seed = 1;
    int32_t word = (int32_t)seed;
    table[0] = (uint32_t)word;
    for (int i = 1; i < 31; ++i) {
      // (16807 * prev) % 2147483647 via Schrage to avoid overflow
      int64_t hi = word / 127773;
      int64_t lo = word % 127773;
      int64_t w = 16807 * lo - 2836 * hi;
      if (w < 0) w += 2147483647;
      word = (int32_t)w;
      table[i] = (uint32_t)word;
    }
    for (int i = 31; i < 34; ++i) table[i] = table[i - 31];
    for (int i = 34; i < 344; ++i) table[i] = table[i - 3] + table[i - 31];
    // keep last 31 values in a ring; outputs start at index 344
    for (int i = 0; i < 31; ++i) ring[i] = table[344 - 31 + i];
    pos = 0;
  }

  inline uint32_t next() {
    // new value = ring[pos - 3 mod 31] + ring[pos - 31 mod 31] where ring[pos]
    // is about to be overwritten (it holds the value 31 steps back).
    uint32_t v = ring[(pos + 31 - 3) % 31] + ring[pos];
    ring[pos] = v;
    pos = (pos + 1) % 31;
    return v >> 1;
  }
};

}  // namespace

extern "C" int rtc_version() { return 1; }

extern "C" void rtc_glibc_rand_stream(uint32_t seed, int64_t n, uint32_t* out) {
  GlibcRand g(seed);
  for (int64_t i = 0; i < n; ++i) out[i] = g.next();
}

// Fisher-Yates exactly as the reference shuffle(): for i = n-1..1,
// j = rand() % (i+1); swap.
extern "C" void rtc_fisher_yates(int32_t* arr, int64_t n, uint32_t seed) {
  GlibcRand g(seed);
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)(g.next() % (uint32_t)(i + 1));
    int32_t t = arr[i];
    arr[i] = arr[j];
    arr[j] = t;
  }
}

// Shuffle table: identity shuffled with seed 23 then seed 348842630.
extern "C" void rtc_generate_shuffle_dim(int half_subk, int32_t* out) {
  int64_t dim_size = 1LL << (4 * half_subk);
  for (int64_t i = 0; i < dim_size; ++i) out[i] = (int32_t)i;
  rtc_fisher_yates(out, dim_size, 23u);
  rtc_fisher_yates(out, dim_size, 348842630u);
}

// ---------------------------------------------------------------------------
// Open-addressing uint64 hash set (dedup of KSSD tuples / MinHash values)
// ---------------------------------------------------------------------------

namespace {

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct U64Set {
  static constexpr uint64_t EMPTY = ~0ULL;
  std::vector<uint64_t> slots;
  uint64_t mask = 0;
  size_t count = 0;
  bool has_empty_val = false;  // tracks the literal value ~0

  U64Set() { reset(1 << 12); }

  void reset(size_t cap) {
    size_t n = 16;
    while (n < cap * 2) n <<= 1;
    slots.assign(n, EMPTY);
    mask = n - 1;
    count = 0;
    has_empty_val = false;
  }

  void clear() {
    std::fill(slots.begin(), slots.end(), EMPTY);
    count = 0;
    has_empty_val = false;
  }

  void grow() {
    std::vector<uint64_t> old;
    old.swap(slots);
    slots.assign(old.size() * 2, EMPTY);
    mask = slots.size() - 1;
    for (uint64_t v : old) {
      if (v == EMPTY) continue;
      size_t i = splitmix64(v) & mask;
      while (slots[i] != EMPTY) i = (i + 1) & mask;
      slots[i] = v;
    }
  }

  inline void insert(uint64_t x) {
    if (x == EMPTY) { has_empty_val = true; return; }
    if ((count + 1) * 4 >= slots.size() * 3) grow();
    size_t i = splitmix64(x) & mask;
    while (slots[i] != EMPTY) {
      if (slots[i] == x) return;
      i = (i + 1) & mask;
    }
    slots[i] = x;
    ++count;
  }

  size_t size() const { return count + (has_empty_val ? 1 : 0); }

  // Extract values sorted ascending.
  void extract_sorted(uint64_t* out) const {
    size_t k = 0;
    for (uint64_t v : slots)
      if (v != EMPTY) out[k++] = v;
    if (has_empty_val) out[k++] = EMPTY;
    std::sort(out, out + k);
  }
};

// ---------------------------------------------------------------------------
// KSSD sketcher — rolling canonical k-mer + shuffled-dimension filter.
// Bit layout mirrors reference src/SketchInfo.cpp:1019-1065,1120-1165.
// ---------------------------------------------------------------------------

static const int8_t kBaseMap[256] = {
    // A=0 C=1 G=2 T=3 (upper & lower), everything else -1
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1,  0, -1,  1, -1, -1, -1,  2, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1,  3, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1,  0, -1,  1, -1, -1, -1,  2, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1,  3, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1};

struct KssdParams {
  int half_k, half_subk, drlevel;
  int kmer_size;
  bool use64;
  int dim_end;
  uint64_t tupmask, domask, undomask0, undomask1;
  int rev_add_move, half_outctx_len_x2, drlevel_x4, shift1;

  void init(int hk, int hsk, int dl) {
    half_k = hk;
    half_subk = hsk;
    drlevel = dl;
    kmer_size = 2 * hk;
    use64 = (hk - dl) > 8;
    dim_end = 1 << (4 * (hsk - dl));
    int comp_bittl = 64 - 4 * hk;
    int half_outctx_len = hk - hsk;
    rev_add_move = 4 * hk - 2;
    tupmask = ~0ULL >> comp_bittl;
    domask = (tupmask >> (4 * half_outctx_len)) << (2 * half_outctx_len);
    uint64_t undomask = (tupmask ^ domask) & tupmask;
    uint64_t u1 = undomask & (tupmask >> ((hk + hsk) * 2));
    undomask1 = u1;
    undomask0 = undomask ^ u1;
    half_outctx_len_x2 = half_outctx_len * 2;
    drlevel_x4 = dl * 4;
    shift1 = kmer_size * 2 - half_outctx_len * 4;
  }
};

struct KssdSketcher {
  KssdParams p;
  const int32_t* shuffled_dim;  // not owned
  U64Set set;

  void update(const char* seq, int64_t len) {
    // Software-pipelined: the shuffle table is 64 MB (4^(2*half_subk)
    // int32 entries) and dim_id is uniform over it, so the naive loop
    // stalls on one cache miss per kmer.  Buffer a block of (uni, dim_id)
    // pairs, issuing the table prefetch as soon as dim_id is known; by
    // the time the block drains, the lines are resident.  Set contents
    // are order-independent (U64Set dedupe + final sort), so results are
    // bit-identical to the serial loop.
    constexpr int BL = 256;
    uint64_t uni_buf[BL];
    uint32_t dim_buf[BL];
    int nb = 0;
    auto drain = [&]() {
      for (int t = 0; t < nb; ++t) {
        int32_t pf = shuffled_dim[dim_buf[t]];
        if ((uint32_t)pf >= (uint32_t)p.dim_end) continue;
        uint64_t uni = uni_buf[t];
        uint64_t dr = (((uni & p.undomask0) |
                        ((uni & p.undomask1) << p.shift1)) >>
                       p.drlevel_x4) |
                      (uint64_t)pf;
        set.insert(dr);
      }
      nb = 0;
    };
    uint64_t tuple = 0, rvs = 0;
    int base = 1;
    const int ksz = p.kmer_size;
    for (int64_t j = 0; j < len; ++j) {
      int b = kBaseMap[(unsigned char)seq[j]];
      if (__builtin_expect(b != -1, 1)) {
        tuple = ((tuple << 2) | (uint64_t)b) & p.tupmask;
        rvs = (rvs >> 2) + (((uint64_t)b ^ 3ULL) << p.rev_add_move);
        ++base;
        if (__builtin_expect(base > ksz, 0)) {
          uint64_t uni = tuple < rvs ? tuple : rvs;
          uint32_t dim_id = (uint32_t)((uni & p.domask) >> p.half_outctx_len_x2);
          __builtin_prefetch(&shuffled_dim[dim_id], 0, 1);
          uni_buf[nb] = uni;
          dim_buf[nb] = dim_id;
          if (__builtin_expect(++nb == BL, 0)) drain();
        }
      } else {
        base = 1;
        tuple = 0;
        rvs = 0;
      }
    }
    drain();
  }
};

// ---------------------------------------------------------------------------
// MinHash bottom-s sketcher (Mash-compatible).
// MurmurHash3 (public domain, Austin Appleby) reimplemented below.
// ---------------------------------------------------------------------------

static inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}
static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}
static inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

static void murmur3_x64_128(const void* key, int len, uint32_t seed, void* out) {
  const uint8_t* data = (const uint8_t*)key;
  const int nblocks = len / 16;
  uint64_t h1 = seed, h2 = seed;
  const uint64_t c1 = 0x87c37b91114253d5ULL, c2 = 0x4cf5ad432745937fULL;
  const uint64_t* blocks = (const uint64_t*)(data);
  for (int i = 0; i < nblocks; i++) {
    uint64_t k1, k2;
    memcpy(&k1, blocks + i * 2, 8);
    memcpy(&k2, blocks + i * 2 + 1, 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }
  const uint8_t* tail = data + nblocks * 16;
  uint64_t k1 = 0, k2 = 0;
  switch (len & 15) {
    case 15: k2 ^= ((uint64_t)tail[14]) << 48; [[fallthrough]];
    case 14: k2 ^= ((uint64_t)tail[13]) << 40; [[fallthrough]];
    case 13: k2 ^= ((uint64_t)tail[12]) << 32; [[fallthrough]];
    case 12: k2 ^= ((uint64_t)tail[11]) << 24; [[fallthrough]];
    case 11: k2 ^= ((uint64_t)tail[10]) << 16; [[fallthrough]];
    case 10: k2 ^= ((uint64_t)tail[9]) << 8; [[fallthrough]];
    case 9:  k2 ^= ((uint64_t)tail[8]) << 0;
             k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2; [[fallthrough]];
    case 8:  k1 ^= ((uint64_t)tail[7]) << 56; [[fallthrough]];
    case 7:  k1 ^= ((uint64_t)tail[6]) << 48; [[fallthrough]];
    case 6:  k1 ^= ((uint64_t)tail[5]) << 40; [[fallthrough]];
    case 5:  k1 ^= ((uint64_t)tail[4]) << 32; [[fallthrough]];
    case 4:  k1 ^= ((uint64_t)tail[3]) << 24; [[fallthrough]];
    case 3:  k1 ^= ((uint64_t)tail[2]) << 16; [[fallthrough]];
    case 2:  k1 ^= ((uint64_t)tail[1]) << 8; [[fallthrough]];
    case 1:  k1 ^= ((uint64_t)tail[0]) << 0;
             k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }
  h1 ^= len; h2 ^= len;
  h1 += h2; h2 += h1;
  h1 = fmix64(h1); h2 = fmix64(h2);
  h1 += h2; h2 += h1;
  ((uint64_t*)out)[0] = h1;
  ((uint64_t*)out)[1] = h2;
}

static uint32_t murmur3_x86_32(const void* key, int len, uint32_t seed) {
  const uint8_t* data = (const uint8_t*)key;
  const int nblocks = len / 4;
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51, c2 = 0x1b873593;
  for (int i = 0; i < nblocks; i++) {
    uint32_t k1;
    memcpy(&k1, data + i * 4, 4);
    k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2;
    h1 ^= k1; h1 = rotl32(h1, 13); h1 = h1 * 5 + 0xe6546b64;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= tail[2] << 16; [[fallthrough]];
    case 2: k1 ^= tail[1] << 8; [[fallthrough]];
    case 1: k1 ^= tail[0];
            k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
  }
  h1 ^= len;
  h1 ^= h1 >> 16; h1 *= 0x85ebca6b; h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35; h1 ^= h1 >> 16;
  return h1;
}

static const char kComp[256] = {
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0, 0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0, 0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    0,'T',0,'G',0,0,0,'C',0,0,0,0,0,0,'N',0, 0,0,0,0,'A',0,0,0,0,0,0,0,0,0,0,0,
    0,'t',0,'g',0,0,0,'c',0,0,0,0,0,0,'n',0, 0,0,0,0,'a',0,0,0,0,0,0,0,0,0,0,0,
};

// Bottom-s MinHash over canonical k-mers (Mash convention: canonical = the
// memcmp-smaller of the k-mer and its reverse complement; hash = MurmurHash3
// seed 42; 64-bit for k > 16, 32-bit otherwise).  Keeps the s smallest
// distinct hash values via a bounded max-heap + membership set.
struct MinHashSketcher {
  int k;
  int s;  // sketch size (bottom-s); if <=0, keep everything (containment uses
          // per-genome size decided by caller via set_capacity)
  std::vector<uint64_t> heap;  // max-heap of kept hashes
  U64Set member;
  std::vector<char> kmer_buf, rc_buf;

  void init(int kk, int ss) {
    k = kk;
    s = ss;
    heap.clear();
    heap.reserve(ss > 0 ? ss : 1024);
    member.reset(ss > 0 ? (size_t)ss : 1024);
    kmer_buf.resize(k);
    rc_buf.resize(k);
  }

  inline void offer(uint64_t h) {
    if (s > 0 && (int)heap.size() >= s) {
      if (h >= heap.front()) return;
    }
    // membership dedup
    size_t before = member.size();
    member.insert(h);
    if (member.size() == before) return;
    heap.push_back(h);
    std::push_heap(heap.begin(), heap.end());
    if (s > 0 && (int)heap.size() > s) {
      std::pop_heap(heap.begin(), heap.end());
      heap.pop_back();
    }
  }

  void update(const char* seq, int64_t len) {
    if (len < k) return;
    const bool use64 = k > 16;
    for (int64_t i = 0; i + k <= len; ++i) {
      // validity + canonical construction
      bool ok = true;
      for (int j = 0; j < k; ++j) {
        char c = seq[i + j];
        if (kBaseMap[(unsigned char)c] < 0) {
          ok = false;
          break;
        }
        // uppercase for hashing (Mash uppercases input)
        kmer_buf[j] = c >= 'a' ? c - 32 : c;
      }
      if (!ok) continue;
      for (int j = 0; j < k; ++j) rc_buf[j] = kComp[(unsigned char)kmer_buf[k - 1 - j]];
      const char* can = memcmp(kmer_buf.data(), rc_buf.data(), k) <= 0
                            ? kmer_buf.data()
                            : rc_buf.data();
      uint64_t h;
      if (use64) {
        uint64_t out[2];
        murmur3_x64_128(can, k, 42, out);
        h = out[0];
      } else {
        h = murmur3_x86_32(can, k, 42);
      }
      offer(h);
    }
  }

  int64_t size() const { return (int64_t)heap.size(); }
  void extract_sorted(uint64_t* out) const {
    std::copy(heap.begin(), heap.end(), out);
    std::sort(out, out + heap.size());
  }
};

// ---------------------------------------------------------------------------
// FASTA(.gz) parsing — buffered reader on zlib gzFile (handles plain files
// transparently).  Own implementation; not kseq.
// ---------------------------------------------------------------------------

struct SeqRecord {
  std::string name, comment, seq;
};

struct FastaReader {
  gzFile fp = nullptr;
  FILE* plain = nullptr;  // plain-file fast path: gzread on uncompressed
                          // input still routes every byte through zlib's
                          // pass-through copy; fread skips it
  std::vector<char> buf;
  int64_t pos = 0, avail = 0;
  bool eof_ = false;

  bool open(const char* path) {
    FILE* probe = fopen(path, "rb");
    if (!probe) return false;
    unsigned char magic[2] = {0, 0};
    size_t got = fread(magic, 1, 2, probe);
    if (got == 2 && magic[0] == 0x1f && magic[1] == 0x8b) {
      fclose(probe);
      fp = gzopen(path, "rb");
      if (!fp) return false;
      gzbuffer(fp, 1 << 20);
    } else {
      rewind(probe);
      plain = probe;
    }
    buf.resize(1 << 20);
    pos = avail = 0;
    eof_ = false;
    return true;
  }
  void close() {
    if (fp) gzclose(fp);
    fp = nullptr;
    if (plain) fclose(plain);
    plain = nullptr;
  }
  inline int peek() {
    if (pos >= avail) {
      if (eof_) return -1;
      avail = plain ? (int64_t)fread(buf.data(), 1, buf.size(), plain)
                    : gzread(fp, buf.data(), (unsigned)buf.size());
      pos = 0;
      if (avail <= 0) {
        eof_ = true;
        return -1;
      }
    }
    return (unsigned char)buf[pos];
  }
  inline int get() {
    int c = peek();
    if (c >= 0) ++pos;
    return c;
  }

  // Read next record; returns false at EOF.
  bool next(SeqRecord& rec) {
    int c;
    while ((c = get()) >= 0 && c != '>') {
    }
    if (c < 0) return false;
    rec.name.clear();
    rec.comment.clear();
    rec.seq.clear();
    // header
    while ((c = get()) >= 0 && c != '\n') {
      if (c == '\r') continue;
      rec.name.push_back((char)c);
    }
    size_t sp = rec.name.find_first_of(" \t");
    if (sp != std::string::npos) {
      rec.comment = rec.name.substr(sp + 1);
      rec.name.resize(sp);
    }
    // sequence lines until next '>' or EOF.  mid_line tracks whether the
    // previous bulk consume ended at a buffer-refill boundary WITHOUT
    // seeing the line's '\n': a '>' byte there is mid-line sequence data
    // (malformed FASTA, but keep byte semantics independent of where the
    // 1 MB buffer boundary happens to land), not a new record header.
    bool mid_line = false;
    while (true) {
      int p = peek();
      if (p < 0) break;
      if (p == '>' && !mid_line) break;
      if (p == '\n' || p == '\r') {
        if (p == '\n') mid_line = false;
        ++pos;
        continue;
      }
      // bulk-consume the buffered run up to the next newline (memchr +
      // slice append; the old per-byte get() loop cost ~8 ns/base and
      // dominated whole-pipeline sketching).  A line spanning a buffer
      // refill just continues on the next outer iteration.
      const char* base = buf.data();
      const char* nl = (const char*)memchr(base + pos, '\n', avail - pos);
      int64_t end = nl ? (int64_t)(nl - base) : avail;
      int64_t stop = end;
      if (memchr(base + pos, '\r', end - pos) == nullptr) {
        rec.seq.append(base + pos, (size_t)(stop - pos));
      } else {  // rare: strip every '\r' (the old loop's semantics)
        for (int64_t q = pos; q < stop; ++q)
          if (base[q] != '\r') rec.seq.push_back(base[q]);
      }
      mid_line = (nl == nullptr);
      pos = end + (nl ? 1 : 0);
    }
    return true;
  }
};

// ---------------------------------------------------------------------------
// Result container handed back to Python
// ---------------------------------------------------------------------------

struct GenomeSketch {
  std::string file_name;
  std::string name, comment;  // first sequence of the genome (or the seq itself)
  int64_t seq0_len = 0;
  int64_t total_len = 0;
  int64_t num_seqs = 0;
  // MinHash PARAMETER sketch size (what the reference's getSketchSize()
  // returns): the fixed -s value in standard mode, max(len/cc, 100) in
  // containment mode.  The greedy engine's bounds/distances use this, not
  // the actual kept-hash count (SketchInfo.cpp:920, greedy.cpp:1202).
  int64_t param_size = 0;
  std::vector<uint64_t> hashes;  // sorted ascending
  int32_t ok = 1;                // 0 if file missing/unreadable
};

struct SketchResult {
  std::vector<GenomeSketch> genomes;
};

}  // namespace

extern "C" {

// ---- shuffle table / sketch-by-files pipeline -----------------------------

// mode 0 = KSSD, 1 = MinHash
// For KSSD: param1 = half_k, param2 = half_subk, param3 = drlevel,
//           shuffled_dim used.  For MinHash: param1 = k, param2 = sketch size
//           (<=0: unbounded for containment with per-genome cap param3>0 ? ...),
//           param3 = containCompress (>0 -> per-genome size max(len/cc, 100)).
void* rtc_sketch_files(const char** files, int64_t nfiles, int64_t min_len,
                       int mode, int param1, int param2, int param3,
                       const int32_t* shuffled_dim, int threads) {
  auto* res = new SketchResult();
  res->genomes.resize(nfiles);
  KssdParams kp;
  if (mode == 0) kp.init(param1, param2, param3);

#pragma omp parallel num_threads(threads)
  {
    KssdSketcher ks;
    ks.p = kp;
    ks.shuffled_dim = shuffled_dim;
    MinHashSketcher ms;
#pragma omp for schedule(dynamic)
    for (int64_t i = 0; i < nfiles; ++i) {
      GenomeSketch& g = res->genomes[i];
      g.file_name = files[i];
      FastaReader rd;
      if (!rd.open(files[i])) {
        g.ok = 0;
        continue;
      }
      if (mode == 0) {
        ks.set.reset(1 << 12);
      } else {
        ms.init(param1, param2 > 0 ? param2 : 0);
      }
      SeqRecord rec;
      bool first = true;
      while (rd.next(rec)) {
        g.total_len += (int64_t)rec.seq.size();
        ++g.num_seqs;
        if (first) {
          g.name = rec.name.empty() ? "noName" : rec.name;
          g.comment = rec.comment.empty() ? "noName" : rec.comment;
          g.seq0_len = (int64_t)rec.seq.size();
          first = false;
        }
        if (mode == 0)
          ks.update(rec.seq.data(), (int64_t)rec.seq.size());
        else
          ms.update(rec.seq.data(), (int64_t)rec.seq.size());
      }
      rd.close();
      if (mode == 1 && param3 > 0) {
        // containment mode: re-cap to per-genome size — handled by caller via
        // a second pass; here we kept everything (param2 <= 0 expected).
      }
      if (g.total_len >= min_len) {
        if (mode == 0) {
          g.hashes.resize(ks.set.size());
          ks.set.extract_sorted(g.hashes.data());
        } else {
          g.hashes.resize(ms.size());
          ms.extract_sorted(g.hashes.data());
          g.param_size = param2;
        }
      }
      // genomes below min_len keep an empty hash vector; caller filters
    }
  }
  return res;
}

// Containment-mode per-genome sketch cap source (SketchInfo.cpp:890-915):
// the raw FILE BYTE SIZE as an int — for .gz files the gzip trailer ISIZE
// (uncompressed size mod 2^32, last 4 little-endian bytes), NOT the total
// sequence length (headers and newlines count).
static int file_length_for_containment(const char* path) {
  FILE* fp = fopen(path, "r");
  if (!fp) return 0;
  int n = 0;
  size_t len = strlen(path);
  if (len >= 2 && strcmp(path + len - 2, "gz") == 0) {
    if (fseek(fp, -4, SEEK_END) == 0 && fread(&n, sizeof(int), 1, fp) == 1) {
    } else {
      n = 0;
    }
  } else {
    fseek(fp, 0, SEEK_END);
    n = (int)ftell(fp);
  }
  fclose(fp);
  return n;
}

// Sketch each SEQUENCE of a single FASTA file as its own genome.
//
// Streaming bounded-memory pipeline (behavioral spec: reference RabbitFX
// producer/consumer, SketchInfo.cpp:498-503,582-594): one reader thread
// fills a byte-bounded record queue, `threads` sketcher threads drain it.
// Peak resident sequence bytes are bounded by RTC_SEQ_QUEUE_BYTES
// (default 256 MB) + one in-flight record per thread — a multi-GB FASTA
// no longer slurps into RAM.  Results keep exact sequence order.
void* rtc_sketch_sequences(const char* file, int64_t min_len, int mode,
                           int param1, int param2, int param3,
                           const int32_t* shuffled_dim, int threads) {
  auto* res = new SketchResult();
  KssdParams kp;
  if (mode == 0) kp.init(param1, param2, param3);

  int64_t max_bytes = 256ll << 20;
  if (const char* e = getenv("RTC_SEQ_QUEUE_BYTES")) {
    int64_t v = atoll(e);
    if (v > 0) max_bytes = v;
  }
  struct Item {
    int64_t idx;
    SeqRecord rec;
  };
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::deque<Item> queue;
  int64_t bytes_in_q = 0;
  bool producer_done = false;
  bool open_ok = true;

  std::thread producer([&] {
    FastaReader rd;
    if (!rd.open(file)) {
      std::lock_guard<std::mutex> lk(mu);
      open_ok = false;
      producer_done = true;
      cv_data.notify_all();
      return;
    }
    int64_t idx = 0;
    SeqRecord rec;
    while (rd.next(rec)) {
      int64_t sz = (int64_t)rec.seq.size();
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return bytes_in_q < max_bytes; });
      bytes_in_q += sz;
      queue.push_back(Item{idx++, std::move(rec)});
      cv_data.notify_one();
    }
    rd.close();
    std::lock_guard<std::mutex> lk(mu);
    producer_done = true;
    cv_data.notify_all();
  });

  std::mutex res_mu;
  int n_workers = threads > 0 ? threads : 1;
  std::vector<std::thread> workers;
  workers.reserve(n_workers);
  for (int w = 0; w < n_workers; ++w) {
    workers.emplace_back([&] {
      KssdSketcher ks;
      ks.p = kp;
      ks.shuffled_dim = shuffled_dim;
      MinHashSketcher ms;
      while (true) {
        Item it;
        {
          std::unique_lock<std::mutex> lk(mu);
          cv_data.wait(lk, [&] { return !queue.empty() || producer_done; });
          if (queue.empty()) break;
          it = std::move(queue.front());
          queue.pop_front();
          bytes_in_q -= (int64_t)it.rec.seq.size();
          cv_space.notify_one();
        }
        GenomeSketch g;
        g.file_name = file;
        g.name = it.rec.name.empty() ? "noName" : it.rec.name;
        g.comment = it.rec.comment.empty() ? "noName" : it.rec.comment;
        g.seq0_len = (int64_t)it.rec.seq.size();
        g.total_len = g.seq0_len;
        g.num_seqs = 1;
        if (g.total_len >= min_len) {
          if (mode == 0) {
            ks.set.reset(1 << 12);
            ks.update(it.rec.seq.data(), g.seq0_len);
            g.hashes.resize(ks.set.size());
            ks.set.extract_sorted(g.hashes.data());
          } else {
            int cap = param2;
            if (param3 > 0) {  // containment: per-sequence sketch size
              // by-sequence mode uses the SEQUENCE length, not file bytes
              // (SketchInfo.cpp:226,705)
              cap = (int)std::max<int64_t>(g.seq0_len / param3, 100);
            }
            g.param_size = cap;
            ms.init(param1, cap);
            ms.update(it.rec.seq.data(), g.seq0_len);
            g.hashes.resize(ms.size());
            ms.extract_sorted(g.hashes.data());
          }
        }
        {
          std::lock_guard<std::mutex> lk(res_mu);
          if ((int64_t)res->genomes.size() <= it.idx)
            res->genomes.resize(it.idx + 1);
          res->genomes[it.idx] = std::move(g);
        }
      }
    });
  }
  producer.join();
  for (auto& t : workers) t.join();
  (void)open_ok;  // missing file -> empty result (caller surfaces it)
  return res;
}

// MinHash containment by file: per-genome sketch size =
// max(fileByteLength/cc, 100) — the reference derives the cap from the raw
// file size (gz: trailer ISIZE), not the sequence length
// (SketchInfo.cpp:890-921).  Parse once for metadata, then sketch.
void* rtc_sketch_files_minhash_contain(const char** files, int64_t nfiles,
                                       int64_t min_len, int k, int cc,
                                       int threads) {
  auto* res = new SketchResult();
  res->genomes.resize(nfiles);
#pragma omp parallel num_threads(threads)
  {
    MinHashSketcher ms;
#pragma omp for schedule(dynamic)
    for (int64_t i = 0; i < nfiles; ++i) {
      GenomeSketch& g = res->genomes[i];
      g.file_name = files[i];
      // pass 1: lengths + metadata
      {
        FastaReader rd;
        if (!rd.open(files[i])) {
          g.ok = 0;
          continue;
        }
        SeqRecord rec;
        bool first = true;
        while (rd.next(rec)) {
          g.total_len += (int64_t)rec.seq.size();
          ++g.num_seqs;
          if (first) {
            g.name = rec.name.empty() ? "noName" : rec.name;
            g.comment = rec.comment.empty() ? "noName" : rec.comment;
            g.seq0_len = (int64_t)rec.seq.size();
            first = false;
          }
        }
        rd.close();
      }
      if (g.total_len < min_len) continue;
      int cap = std::max(file_length_for_containment(files[i]) / cc, 100);
      g.param_size = cap;
      ms.init(k, cap);
      {
        FastaReader rd;
        if (!rd.open(files[i])) {
          g.ok = 0;
          continue;
        }
        SeqRecord rec;
        while (rd.next(rec)) ms.update(rec.seq.data(), (int64_t)rec.seq.size());
        rd.close();
      }
      g.hashes.resize(ms.size());
      ms.extract_sorted(g.hashes.data());
    }
  }
  return res;
}

// ---- result accessors ------------------------------------------------------

int64_t rtc_result_count(void* h) {
  return (int64_t)((SketchResult*)h)->genomes.size();
}
int32_t rtc_result_ok(void* h, int64_t i) {
  return ((SketchResult*)h)->genomes[i].ok;
}
int64_t rtc_result_total_len(void* h, int64_t i) {
  return ((SketchResult*)h)->genomes[i].total_len;
}
int64_t rtc_result_param_size(void* h, int64_t i) {
  return ((SketchResult*)h)->genomes[i].param_size;
}
int64_t rtc_result_seq0_len(void* h, int64_t i) {
  return ((SketchResult*)h)->genomes[i].seq0_len;
}
int64_t rtc_result_num_seqs(void* h, int64_t i) {
  return ((SketchResult*)h)->genomes[i].num_seqs;
}
int64_t rtc_result_sketch_size(void* h, int64_t i) {
  return (int64_t)((SketchResult*)h)->genomes[i].hashes.size();
}
void rtc_result_hashes(void* h, int64_t i, uint64_t* out) {
  const auto& v = ((SketchResult*)h)->genomes[i].hashes;
  memcpy(out, v.data(), v.size() * sizeof(uint64_t));
}
const char* rtc_result_name(void* h, int64_t i) {
  return ((SketchResult*)h)->genomes[i].name.c_str();
}
const char* rtc_result_comment(void* h, int64_t i) {
  return ((SketchResult*)h)->genomes[i].comment.c_str();
}
const char* rtc_result_file(void* h, int64_t i) {
  return ((SketchResult*)h)->genomes[i].file_name.c_str();
}
void rtc_result_free(void* h) { delete (SketchResult*)h; }

// ---- bulk result extraction (one ctypes call per field instead of 8 per
// genome: the per-genome Python loop cost ~0.5 s at 10k genomes) ----------
void rtc_result_meta(void* h, int32_t* ok, int64_t* seq0, int64_t* total,
                     int64_t* nseq, int64_t* psize, int64_t* ssize) {
  auto& gs = ((SketchResult*)h)->genomes;
  for (size_t i = 0; i < gs.size(); ++i) {
    ok[i] = gs[i].ok;
    seq0[i] = gs[i].seq0_len;
    total[i] = gs[i].total_len;
    nseq[i] = gs[i].num_seqs;
    psize[i] = gs[i].param_size;
    ssize[i] = (int64_t)gs[i].hashes.size();
  }
}
// field: 0 = name, 1 = comment, 2 = file_name; strings '\0'-joined
int64_t rtc_result_strings_len(void* h, int field) {
  auto& gs = ((SketchResult*)h)->genomes;
  int64_t total = 0;
  for (auto& g : gs)
    total += 1 + (int64_t)(field == 0 ? g.name
                           : field == 1 ? g.comment : g.file_name).size();
  return total;
}
void rtc_result_strings(void* h, int field, char* out) {
  auto& gs = ((SketchResult*)h)->genomes;
  for (auto& g : gs) {
    const std::string& s = field == 0 ? g.name
                           : field == 1 ? g.comment : g.file_name;
    memcpy(out, s.data(), s.size());
    out += s.size();
    *out++ = '\0';
  }
}
void rtc_result_hashes_all(void* h, uint64_t* out) {
  auto& gs = ((SketchResult*)h)->genomes;
  for (auto& g : gs) {
    memcpy(out, g.hashes.data(), g.hashes.size() * sizeof(uint64_t));
    out += g.hashes.size();
  }
}

// ---- incremental single sketcher (tests / streaming) ----------------------

void* rtc_kssd_create(int half_k, int half_subk, int drlevel,
                      const int32_t* shuffled_dim) {
  auto* s = new KssdSketcher();
  s->p.init(half_k, half_subk, drlevel);
  s->shuffled_dim = shuffled_dim;
  return s;
}
void rtc_kssd_reset(void* s) { ((KssdSketcher*)s)->set.reset(1 << 12); }
void rtc_kssd_update(void* s, const char* seq, int64_t len) {
  ((KssdSketcher*)s)->update(seq, len);
}
int64_t rtc_kssd_size(void* s) { return (int64_t)((KssdSketcher*)s)->set.size(); }
void rtc_kssd_extract(void* s, uint64_t* out) {
  ((KssdSketcher*)s)->set.extract_sorted(out);
}
void rtc_kssd_destroy(void* s) { delete (KssdSketcher*)s; }

// ---- exact pair verification (two-pointer over CSR sketch store) ----------
// Used by the bitmap-filter + exact-verify pipeline and by host engines.

// Bit-packed signature construction for the device bitmap filter:
// bit index = (h * 0x9E3779B97F4A7C15) >> (64 - log2(bits)).
// out: n rows x bits/8 bytes (little bit order); coll[g] = size - popcount.
void rtc_pack_bitmaps_u32(const uint32_t* flat, const int64_t* offs,
                          int64_t n, int bits, uint8_t* out, int32_t* coll,
                          int threads) {
  const int shift = 64 - __builtin_ctz(bits);
  const int64_t row_bytes = bits / 8;
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t g = 0; g < n; ++g) {
    uint8_t* row = out + g * row_bytes;
    memset(row, 0, row_bytes);
    for (int64_t p = offs[g]; p < offs[g + 1]; ++p) {
      uint64_t b = ((uint64_t)flat[p] * 0x9E3779B97F4A7C15ULL) >> shift;
      row[b >> 3] |= (uint8_t)(1u << (b & 7));
    }
    int pc = 0;
    for (int64_t k = 0; k < row_bytes; k += 8) {  // bits/8 is 8-aligned
      uint64_t v;
      memcpy(&v, row + k, 8);
      pc += __builtin_popcountll(v);
    }
    coll[g] = (int32_t)(offs[g + 1] - offs[g]) - pc;
  }
}

void rtc_pack_bitmaps_u64(const uint64_t* flat, const int64_t* offs,
                          int64_t n, int bits, uint8_t* out, int32_t* coll,
                          int threads) {
  const int shift = 64 - __builtin_ctz(bits);
  const int64_t row_bytes = bits / 8;
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t g = 0; g < n; ++g) {
    uint8_t* row = out + g * row_bytes;
    memset(row, 0, row_bytes);
    for (int64_t p = offs[g]; p < offs[g + 1]; ++p) {
      uint64_t b = (flat[p] * 0x9E3779B97F4A7C15ULL) >> shift;
      row[b >> 3] |= (uint8_t)(1u << (b & 7));
    }
    int pc = 0;
    for (int64_t k = 0; k < row_bytes; k += 8) {  // bits/8 is 8-aligned
      uint64_t v;
      memcpy(&v, row + k, 8);
      pc += __builtin_popcountll(v);
    }
    coll[g] = (int32_t)(offs[g + 1] - offs[g]) - pc;
  }
}

// Extract global (i, j) candidate pairs from a bit-PACKED tile mask
// (rows x row_bytes, little bit order — the device mask program's pull
// format).  Two passes: parallel per-row popcount prefix, then parallel
// bit-scan emit at stable offsets.  Rows with global i >= n_limit are
// skipped (device already masks them via sizes==0; kept as a guard).
// Returns the number of pairs written.
int64_t rtc_mask_pairs(const uint8_t* packed, int64_t rows,
                       int64_t row_bytes, int64_t r0, int64_t c0,
                       int64_t n_limit, int64_t* out_i, int64_t* out_j,
                       int threads) {
  std::vector<int64_t> off(rows + 1, 0);
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t r = 0; r < rows; ++r) {
    if (r0 + r >= n_limit) { off[r + 1] = 0; continue; }
    const uint8_t* row = packed + r * row_bytes;
    int64_t pc = 0, k = 0;
    for (; k + 8 <= row_bytes; k += 8) {
      uint64_t w;
      memcpy(&w, row + k, 8);
      pc += __builtin_popcountll(w);
    }
    for (; k < row_bytes; ++k) pc += __builtin_popcount(row[k]);
    off[r + 1] = pc;
  }
  for (int64_t r = 0; r < rows; ++r) off[r + 1] += off[r];
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t r = 0; r < rows; ++r) {
    if (r0 + r >= n_limit) continue;
    const uint8_t* row = packed + r * row_bytes;
    int64_t w_off = off[r];
    const int64_t gi = r0 + r;
    int64_t k = 0;
    for (; k + 8 <= row_bytes; k += 8) {
      uint64_t w;
      memcpy(&w, row + k, 8);
      while (w) {
        int b = __builtin_ctzll(w);
        out_i[w_off] = gi;
        out_j[w_off] = c0 + k * 8 + b;
        ++w_off;
        w &= w - 1;
      }
    }
    for (; k < row_bytes; ++k) {
      uint32_t w = row[k];
      while (w) {
        int b = __builtin_ctz(w);
        out_i[w_off] = gi;
        out_j[w_off] = c0 + k * 8 + b;
        ++w_off;
        w &= w - 1;
      }
    }
  }
  return off[rows];
}

void rtc_count_common_u32(const uint32_t* flat, const int64_t* offs,
                          const int32_t* ii, const int32_t* jj,
                          int64_t npairs, int32_t* out, int threads) {
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t p = 0; p < npairs; ++p) {
    const uint32_t* a = flat + offs[ii[p]];
    const uint32_t* ae = flat + offs[ii[p] + 1];
    const uint32_t* b = flat + offs[jj[p]];
    const uint32_t* be = flat + offs[jj[p] + 1];
    int32_t c = 0;
    while (a < ae && b < be) {
      uint32_t x = *a, y = *b;
      c += (x == y);
      a += (x <= y);
      b += (y <= x);
    }
    out[p] = c;
  }
}

void rtc_count_common_u64(const uint64_t* flat, const int64_t* offs,
                          const int32_t* ii, const int32_t* jj,
                          int64_t npairs, int32_t* out, int threads) {
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t p = 0; p < npairs; ++p) {
    const uint64_t* a = flat + offs[ii[p]];
    const uint64_t* ae = flat + offs[ii[p] + 1];
    const uint64_t* b = flat + offs[jj[p]];
    const uint64_t* be = flat + offs[jj[p] + 1];
    int32_t c = 0;
    while (a < ae && b < be) {
      uint64_t x = *a, y = *b;
      c += (x == y);
      a += (x <= y);
      b += (y <= x);
    }
    out[p] = c;
  }
}

}  // extern "C" (reopened below after the MST engine internals)

// ---- native MST engine ----------------------------------------------------
// Full candidate-generation + distance + streaming-Kruskal pipeline over CSR
// sketches (behavioral spec: reference src/MST.cpp:216-807; written fresh).
// Work: inverted index via parallel sort of (hash, gid); per-genome
// epoch-stamped intersection accumulation; per-thread partial MSTs; final
// merge.  Returns merged MST edges + optional dense/ANI histograms.

namespace {

struct MstOut {
  std::vector<int32_t> ei, ej;
  std::vector<double> ed;
  std::vector<int32_t> dense;   // denseSpan * n (cumulative) if requested
  std::vector<uint64_t> ani;    // 101 if requested
};

struct EdgeRec {
  int32_t i, j;
  double d;
};

struct UF {
  std::vector<int32_t> p;
  std::vector<int8_t> r;
  explicit UF(int n) : p(n), r(n, 0) {
    for (int i = 0; i < n; ++i) p[i] = i;
  }
  int find(int x) {
    while (p[x] != x) {
      p[x] = p[p[x]];
      x = p[x];
    }
    return x;
  }
  bool merge(int a, int b) {
    a = find(a);
    b = find(b);
    if (a == b) return false;
    if (r[a] < r[b]) std::swap(a, b);
    p[b] = a;
    if (r[a] == r[b]) ++r[a];
    return true;
  }
};

static void kruskal_reduce(std::vector<EdgeRec>& edges, int n) {
  std::sort(edges.begin(), edges.end(), [](const EdgeRec& a, const EdgeRec& b) {
    if (a.d != b.d) return a.d < b.d;
    if (a.i != b.i) return a.i < b.i;
    return a.j < b.j;
  });
  UF uf(n);
  size_t keep = 0;
  for (size_t k = 0; k < edges.size(); ++k) {
    if (uf.merge(edges[k].i, edges[k].j)) edges[keep++] = edges[k];
  }
  edges.resize(keep);
}

static void kruskal_reduce_parity(std::vector<EdgeRec>& edges, int n) {
  // Reference serial reduce (MST.cpp:571-573): UNSTABLE std::sort with a
  // dist-only comparator (cmpEdge, MST.cpp:17-19) followed by in-order
  // Kruskal.  Using the real libstdc++ std::sort on the same input
  // sequence reproduces the reference's tie resolution bit-for-bit, which
  // makes edge.mst byte-identical at -t 1 even under exact float64
  // distance ties.
  std::sort(edges.begin(), edges.end(),
            [](const EdgeRec& a, const EdgeRec& b) { return a.d < b.d; });
  UF uf(n);
  size_t keep = 0;
  for (size_t k = 0; k < edges.size(); ++k) {
    if (uf.merge(edges[k].i, edges[k].j)) edges[keep++] = edges[k];
  }
  edges.resize(keep);
}

template <typename HashT>
MstOut mst_engine(const HashT* flat, const int64_t* offs, int64_t n,
                  double threshold, int kmer_size, bool containment,
                  int64_t start_index, bool with_dense, int threads) {
  MstOut out;
  if (n < 2) return out;
  const int dense_span = 100;
  // 1) inverted index: sort (hash, gid) pairs; postings = runs
  const int64_t m = offs[n];
  std::vector<std::pair<HashT, uint32_t>> hv(m);
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t g = 0; g < n; ++g)
    for (int64_t p = offs[g]; p < offs[g + 1]; ++p)
      hv[p] = {flat[p], (uint32_t)g};
  // (hash, gid) keys are unique, so the parallel sort's output array is
  // identical to std::sort's (no tie permutation to replicate)
  if (threads > 1) __gnu_parallel::sort(hv.begin(), hv.end());
  else std::sort(hv.begin(), hv.end());
  // run starts per position + per-genome position lists
  std::vector<int64_t> run_start(m);
  for (int64_t p = 0; p < m; ++p)
    run_start[p] = (p > 0 && hv[p].first == hv[p - 1].first)
                       ? run_start[p - 1] : p;
  // positions of each genome's hashes in hv (sorted order):
  // build via counting sort on gid
  std::vector<int64_t> gcount(n + 1, 0);
  for (int64_t p = 0; p < m; ++p) gcount[hv[p].second + 1]++;
  for (int64_t g = 0; g < n; ++g) gcount[g + 1] += gcount[g];
  std::vector<int64_t> gpos(m);
  {
    std::vector<int64_t> cur(gcount.begin(), gcount.end() - 1);
    for (int64_t p = 0; p < m; ++p) gpos[cur[hv[p].second]++] = p;
  }

  const int radio = (int)(2.0 * std::exp(threshold * (kmer_size - 1)) - 1.0);
  const double inv_k = 1.0 / kmer_size;

  // Serial (-t 1) runs replicate the reference cadence exactly
  // (MST.cpp:388-766): subSize=8 genome blocks, each followed by an
  // unstable dist-only sort + Kruskal over [current MST ++ new edges];
  // tail genomes ((n-start) % 8) accumulate and get ONE final reduce.
  // This plus kruskal_reduce_parity makes edge.mst byte-identical to the
  // reference at -t 1.  Multithreaded runs keep the adaptive cadence
  // (the reference itself is completion-order nondeterministic there).
  const bool parity = (threads == 1);
  const int64_t sub_size = 8;
  const int64_t tail_n = parity ? (n - start_index) % sub_size : 0;

  std::vector<std::vector<EdgeRec>> thread_edges(threads);
  std::vector<std::vector<int32_t>> thread_dense;
  std::vector<std::vector<uint64_t>> thread_ani;
  if (with_dense) {
    thread_dense.assign(threads, std::vector<int32_t>(dense_span * n, 0));
    thread_ani.assign(threads, std::vector<uint64_t>(101, 0));
  }

#pragma omp parallel num_threads(threads)
  {
    int tid = omp_get_thread_num();
    auto& edges = thread_edges[tid];
    std::vector<int32_t> inter(n, 0);
    std::vector<int32_t> stamp(n, 0);
    int32_t epoch = 0;
    std::vector<int32_t> touched;
    touched.reserve(4096);
    size_t since_reduce = 0;

#pragma omp for schedule(dynamic, 8)
    for (int64_t i = start_index; i < n; ++i) {
      const int64_t size0 = offs[i + 1] - offs[i];
      if (size0 == 0) continue;
      touched.clear();
      if (++epoch == INT32_MAX) {
        std::fill(stamp.begin(), stamp.end(), 0);
        epoch = 1;
      }
      for (int64_t q = gcount[i]; q < gcount[i + 1]; ++q) {
        int64_t p = gpos[q];
        for (int64_t r = run_start[p]; r < m && hv[r].first == hv[p].first;
             ++r) {
          int32_t cur = (int32_t)hv[r].second;
          if (cur >= i) break;  // gid ascending within run; only j < i
          if (stamp[cur] != epoch) {
            stamp[cur] = epoch;
            inter[cur] = 1;
            touched.push_back(cur);
          } else {
            inter[cur]++;
          }
        }
      }
      for (int32_t j : touched) {
        const int64_t size1 = offs[j + 1] - offs[j];
        if (size1 == 0) continue;
        const int64_t mn = size0 < size1 ? size0 : size1;
        const int64_t mx = size0 > size1 ? size0 : size1;
        if (mx > (int64_t)radio * mn) continue;
        const int32_t common = inter[j];
        double dist;
        if (!containment) {
          const int64_t denom = size0 + size1 - common;
          double jac = denom == 0 ? 0.0 : (double)common / (double)denom;
          if (jac == 1.0) dist = 0.0;
          else if (jac == 0.0) dist = 1.0;
          else dist = -inv_k * std::log(2.0 * jac / (1.0 + jac));
        } else {
          double c = mn == 0 ? 0.0 : (double)common / (double)mn;
          if (c == 1.0) dist = 0.0;
          else if (c == 0.0) dist = 1.0;
          else dist = -inv_k * std::log(c);
        }
        if (with_dense) {
          // lower_bound on {0, 0.01, ..., 0.99}
          int t0 = (int)std::ceil(dist * dense_span - 1e-12);
          if (t0 < 0) t0 = 0;
          if (dist <= 0.0) t0 = 0;
          if (t0 < dense_span) {
            thread_dense[tid][(size_t)t0 * n + i]++;
            thread_dense[tid][(size_t)t0 * n + j]++;
          }
          int a = (int)((1.0 - dist) * 100.0);
          if (a >= 101) a = 100;
          if (a < 0) a = 0;
          thread_ani[tid][a]++;
        }
        edges.push_back({(int32_t)i, j, dist});
      }
      if (parity) {
        if (i < n - tail_n && (i - start_index + 1) % sub_size == 0)
          kruskal_reduce_parity(edges, (int)n);
      } else {
        since_reduce += touched.size();
        if (since_reduce > (size_t)(8 * n) && edges.size() > (size_t)(2 * n)) {
          kruskal_reduce(edges, (int)n);
          since_reduce = 0;
        }
      }
    }
    if (parity) {
      // reference tail reduce (MST.cpp:759-763): only when a tail exists
      // and the accumulated array is non-empty; NO extra reduce otherwise
      if (tail_n > 0 && !edges.empty()) kruskal_reduce_parity(edges, (int)n);
    } else {
      kruskal_reduce(edges, (int)n);
    }
  }

  // merge per-thread partial MSTs.  The reference re-sorts the merged
  // graph once more with cmpEdge and reruns Kruskal (MST.cpp:778-786)
  // even at -t 1 — parity mode must replicate that final unstable sort,
  // since introsort can swap adjacent equal-weight elements of an
  // already-sorted array.
  std::vector<EdgeRec> all;
  for (auto& te : thread_edges) {
    all.insert(all.end(), te.begin(), te.end());
    te.clear();
  }
  if (parity) kruskal_reduce_parity(all, (int)n);
  else kruskal_reduce(all, (int)n);
  out.ei.reserve(all.size());
  out.ej.reserve(all.size());
  out.ed.reserve(all.size());
  for (auto& e : all) {
    out.ei.push_back(e.i);
    out.ej.push_back(e.j);
    out.ed.push_back(e.d);
  }
  if (with_dense) {
    out.dense.assign((size_t)dense_span * n, 0);
    out.ani.assign(101, 0);
    for (int t = 0; t < threads; ++t) {
      for (size_t k = 0; k < out.dense.size(); ++k)
        out.dense[k] += thread_dense[t][k];
      for (int k = 0; k < 101; ++k) out.ani[k] += thread_ani[t][k];
    }
    // cumulative over radius buckets
    for (int64_t g = 0; g < n; ++g) {
      int32_t acc = 0;
      for (int t = 0; t < dense_span; ++t) {
        acc += out.dense[(size_t)t * n + g];
        out.dense[(size_t)t * n + g] = acc;
      }
    }
  }
  return out;
}

}  // namespace

extern "C" {

void* rtc_mst_u32(const uint32_t* flat, const int64_t* offs, int64_t n,
                  double threshold, int kmer_size, int containment,
                  int64_t start_index, int with_dense, int threads) {
  return new MstOut(mst_engine<uint32_t>(flat, offs, n, threshold, kmer_size,
                                         containment != 0, start_index,
                                         with_dense != 0, threads));
}
void* rtc_mst_u64(const uint64_t* flat, const int64_t* offs, int64_t n,
                  double threshold, int kmer_size, int containment,
                  int64_t start_index, int with_dense, int threads) {
  return new MstOut(mst_engine<uint64_t>(flat, offs, n, threshold, kmer_size,
                                         containment != 0, start_index,
                                         with_dense != 0, threads));
}
int64_t rtc_mst_edge_count(void* h) { return (int64_t)((MstOut*)h)->ei.size(); }
void rtc_mst_edges(void* h, int32_t* ei, int32_t* ej, double* ed) {
  MstOut* o = (MstOut*)h;
  memcpy(ei, o->ei.data(), o->ei.size() * 4);
  memcpy(ej, o->ej.data(), o->ej.size() * 4);
  memcpy(ed, o->ed.data(), o->ed.size() * 8);
}
int32_t rtc_mst_has_dense(void* h) { return ((MstOut*)h)->dense.empty() ? 0 : 1; }
void rtc_mst_dense(void* h, int32_t* dense, uint64_t* ani) {
  MstOut* o = (MstOut*)h;
  memcpy(dense, o->dense.data(), o->dense.size() * 4);
  memcpy(ani, o->ani.data(), o->ani.size() * 8);
}
void rtc_mst_free(void* h) { delete (MstOut*)h; }

// ---- file size pre-scan (calSize equivalent: parse for true lengths) ------

void rtc_scan_lengths(const char** files, int64_t nfiles, int64_t* out_len,
                      int threads) {
#pragma omp parallel for schedule(dynamic) num_threads(threads)
  for (int64_t i = 0; i < nfiles; ++i) {
    FastaReader rd;
    int64_t total = 0;
    if (rd.open(files[i])) {
      SeqRecord rec;
      while (rd.next(rec)) total += (int64_t)rec.seq.size();
      rd.close();
    } else {
      total = -1;
    }
    out_len[i] = total;
  }
}

}  // extern "C"

// ---- native greedy engine ---------------------------------------------------
// Serial inverted-index greedy clustering (behavioral spec: reference
// src/greedy.cpp:566-899 / our golden-tested cluster/greedy.py; written
// fresh).  Input sketches must already be size-descending sorted (ties by
// id) — the caller passes the sorted CSR view.  Semantics replicated
// exactly: first-touch candidate order (hashes walked in sketch order,
// posting lists in insertion order), strict max-similarity with
// first-touch tie win, common-bound filters (ceil in f64), monotonic
// pruning with int-truncated max_acceptable.  Output: best_rep[j] = chosen
// representative's (sorted) index, or -1 if genome j became a new
// representative.

namespace {

// Open-addressing hash -> posting-list table (linear probing, power-of-2
// capacity).  The probe loop is the greedy hot path; std::unordered_map's
// pointer chasing costs ~2.5x here, this table is one cache miss per
// lookup (the reference vendors phmap Swiss tables for the same reason).
template <typename HashT>
struct RepPostings {
  std::vector<HashT> keys;
  std::vector<int32_t> slot;  // -1 empty, else index into lists
  std::vector<std::vector<int32_t>> lists;
  size_t mask = 63, used = 0;

  RepPostings() { clear(64); }
  void clear(size_t cap) {
    size_t c = 64;
    while (c < cap * 2) c <<= 1;
    keys.assign(c, 0);
    slot.assign(c, -1);
    mask = c - 1;
    used = 0;
  }
  static inline size_t mix(uint32_t h) {
    return (size_t)(h * 2654435761u);
  }
  static inline size_t mix(uint64_t h) {
    return (size_t)(h * 0x9E3779B97F4A7C15ULL >> 16);
  }
  inline size_t find_slot(HashT h) const {
    size_t i = mix(h) & mask;
    while (slot[i] != -1 && keys[i] != h) i = (i + 1) & mask;
    return i;
  }
  inline const std::vector<int32_t>* find(HashT h) const {
    size_t i = find_slot(h);
    return slot[i] == -1 ? nullptr : &lists[(size_t)slot[i]];
  }
  void grow() {
    std::vector<HashT> ok;
    std::vector<int32_t> os;
    ok.swap(keys);
    os.swap(slot);
    keys.assign((ok.size() << 1), 0);
    slot.assign((os.size() << 1), -1);
    mask = keys.size() - 1;
    for (size_t i = 0; i < ok.size(); ++i) {
      if (os[i] == -1) continue;
      size_t t = mix(ok[i]) & mask;
      while (slot[t] != -1) t = (t + 1) & mask;
      keys[t] = ok[i];
      slot[t] = os[i];
    }
  }
  inline std::vector<int32_t>& get_or_create(HashT h) {
    if ((used + 1) * 10 > (mask + 1) * 7) grow();
    size_t i = find_slot(h);
    if (slot[i] == -1) {
      keys[i] = h;
      slot[i] = (int32_t)lists.size();
      lists.emplace_back();
      ++used;
    }
    return lists[(size_t)slot[i]];
  }
};

template <typename HashT>
void greedy_engine(const HashT* flat, const int64_t* offs, int64_t n,
                   double j_min, double c_min, bool containment,
                   int64_t prune_interval, int32_t* best_out) {
  if (n <= 0) return;
  best_out[0] = -1;
  RepPostings<HashT> index;
  index.clear((size_t)std::min<int64_t>(
      std::max<int64_t>(offs[n] / 50, 1 << 16), int64_t(1) << 24));
  std::vector<char> is_rep((size_t)n, 0);

  auto add_rep = [&](int64_t g) {
    is_rep[(size_t)g] = 1;
    for (int64_t p = offs[g]; p < offs[g + 1]; ++p)
      index.get_or_create(flat[p]).push_back((int32_t)g);
  };
  add_rep(0);

  std::vector<int32_t> inter((size_t)n, 0);
  std::vector<int32_t> stamp((size_t)n, 0);
  int32_t epoch = 0;
  std::vector<int32_t> touched;
  touched.reserve(4096);
  int64_t min_seen = int64_t(1) << 62;

  for (int64_t j = 1; j < n; ++j) {
    const int64_t size_ref = offs[j + 1] - offs[j];
    if (j >= prune_interval && j % prune_interval == 0) {
      // monotonic prune (cluster/greedy.py prune_too_large_monotonic)
      min_seen = std::min(min_seen, size_ref);
      const int64_t max_acceptable =
          (int64_t)((double)min_seen / (j_min * 0.8));
      bool any = false;
      for (int64_t g = 0; g < j && !any; ++g)
        any = is_rep[(size_t)g] && (offs[g + 1] - offs[g]) > max_acceptable;
      if (any) {
        for (int64_t g = 0; g < j; ++g)
          if (is_rep[(size_t)g] && (offs[g + 1] - offs[g]) > max_acceptable)
            is_rep[(size_t)g] = 0;
        for (auto& lst : index.lists) {  // emptied lists keep their slot
          size_t keep = 0;
          for (size_t k = 0; k < lst.size(); ++k)
            if (is_rep[(size_t)lst[k]]) lst[keep++] = lst[k];
          lst.resize(keep);
        }
      }
    }

    // probe: first-touch order
    touched.clear();
    if (++epoch == INT32_MAX) {
      std::fill(stamp.begin(), stamp.end(), 0);
      epoch = 1;
    }
    for (int64_t p = offs[j]; p < offs[j + 1]; ++p) {
      const std::vector<int32_t>* lst = index.find(flat[p]);
      if (lst == nullptr) continue;
      for (int32_t r : *lst) {
        if (stamp[(size_t)r] != epoch) {
          stamp[(size_t)r] = epoch;
          inter[(size_t)r] = 1;
          touched.push_back(r);
        } else {
          inter[(size_t)r]++;
        }
      }
    }

    double best_sim = -1.0;
    int32_t best_rep = -1;
    for (int32_t rep : touched) {
      const int64_t size_qry = offs[rep + 1] - offs[rep];
      const int32_t common = inter[(size_t)rep];
      double sim;
      if (containment) {
        const int64_t mn = std::min(size_ref, size_qry);
        if ((double)common < std::ceil(c_min * (double)mn)) continue;
        sim = mn == 0 ? 1.0 : (double)common / (double)mn;
      } else {
        const double common_min =
            std::ceil(j_min * (double)(size_ref + size_qry) / (1.0 + j_min));
        if ((double)common < common_min) continue;
        const int64_t denom = size_ref + size_qry - common;
        sim = denom == 0 ? 1.0 : (double)common / (double)denom;
      }
      if (sim > best_sim) {  // strict: first-touch wins ties
        best_sim = sim;
        best_rep = rep;
      }
    }

    best_out[j] = best_rep;
    if (best_rep == -1) add_rep(j);
  }
}

}  // namespace

extern "C" {

void rtc_greedy_u32(const uint32_t* flat, const int64_t* offs, int64_t n,
                    double j_min, double c_min, int containment,
                    int64_t prune_interval, int32_t* best_out) {
  greedy_engine<uint32_t>(flat, offs, n, j_min, c_min, containment != 0,
                          prune_interval, best_out);
}

void rtc_greedy_u64(const uint64_t* flat, const int64_t* offs, int64_t n,
                    double j_min, double c_min, int containment,
                    int64_t prune_interval, int32_t* best_out) {
  greedy_engine<uint64_t>(flat, offs, n, j_min, c_min, containment != 0,
                          prune_interval, best_out);
}

// Reference-parity MinHash greedy (behavioral spec:
// MinHashGreedyClusterWithInvertedIndex, src/greedy.cpp:986-1360 — the
// DEFAULT clust-greedy MinHash path; use_inverted_index defaults true and
// the CLI11 flag cannot unset it, so the plain greedyCluster loop is
// unreachable).  Semantics replicated exactly:
//   * NO sketch sort here — the fresh-genome path runs in input order;
//     the presketched path is length-sorted by the CALLER
//     (cmpGenomeSize/cmpSeqSize, sub_command.cpp:2658-2660)
//   * NO pruning
//   * first-touch candidate order (query hashes in sorted array order,
//     posting lists in rep insertion order)
//   * fast path iff the first min(100, n) genomes are standard-mode with
//     identical PARAM sketch size (the reference only SAMPLES 100): bound
//     fixed_common_min = (int)ceil(jmin*2S/(1+jmin)), winner = max common
//     (strict >, first touch wins ties), NO distance check
//   * slow path: bound ceil(jmin*min(sizeRef,sizeQry)) [containment] or
//     ceil(jmin*(sizeRef+sizeQry)/(1+jmin)) [standard]; distance is the
//     MASH transform -log(2c/(1+c))/k of c=common/min (containment) or of
//     jaccard=common/(sizeRef+sizeQry-common), clamped to 1.0; accept
//     dist <= threshold, winner = min dist (strict <, first touch wins)
//   * sizeRef = the query's ACTUAL kept-hash count; sizeQry = the rep's
//     PARAM sketch size (getSketchSize()) — asymmetric on purpose
// param_sizes[i] = per-genome parameter sketch size.  out_best[j] = rep
// input index or -1 (new representative).
void rtc_greedy_minhash(const uint64_t* flat, const int64_t* offs, int64_t n,
                        const int64_t* param_sizes, double threshold,
                        int kmer_size, int is_containment,
                        int32_t* out_best) {
  if (n <= 0) return;
  const double x = std::exp(-threshold * kmer_size);
  const double jaccard_min = x / (2.0 - x);

  bool all_fixed = true;
  bool all_std = !is_containment;
  const int fixed_size = (int)param_sizes[0];
  const int64_t sample = std::min<int64_t>(100, n);
  for (int64_t i = 1; i < sample; ++i) {
    if (is_containment || (int)param_sizes[i] != fixed_size) {
      all_fixed = false;
      all_std = false;
      break;
    }
  }
  const bool fast = all_fixed && all_std;
  const int fixed_common_min =
      fast ? (int)std::ceil(jaccard_min * (2 * fixed_size) /
                            (1.0 + jaccard_min))
           : 0;

  RepPostings<uint64_t> index;
  index.clear((size_t)std::min<int64_t>(
      std::max<int64_t>(offs[n] / 50, 1 << 16), int64_t(1) << 24));
  auto add_rep = [&](int64_t g) {
    for (int64_t p = offs[g]; p < offs[g + 1]; ++p)
      index.get_or_create(flat[p]).push_back((int32_t)g);
  };
  out_best[0] = -1;
  add_rep(0);

  std::vector<int32_t> cnt((size_t)n, 0);
  std::vector<int32_t> mark((size_t)n, 0);
  int32_t cur_mark = 0;
  std::vector<int32_t> touched;
  touched.reserve(4096);

  for (int64_t j = 1; j < n; ++j) {
    const int size_ref = (int)(offs[j + 1] - offs[j]);  // ACTUAL kept count
    touched.clear();
    if (++cur_mark == INT32_MAX) {
      std::fill(mark.begin(), mark.end(), 0);
      cur_mark = 1;
    }
    for (int64_t p = offs[j]; p < offs[j + 1]; ++p) {
      const std::vector<int32_t>* lst = index.find(flat[p]);
      if (lst == nullptr) continue;
      for (int32_t r : *lst) {
        if (mark[(size_t)r] != cur_mark) {
          mark[(size_t)r] = cur_mark;
          cnt[(size_t)r] = 1;
          touched.push_back(r);
        } else {
          cnt[(size_t)r]++;
        }
      }
    }

    int best_common = -1;
    double best_dist = std::numeric_limits<double>::max();
    int32_t best_rep = -1;
    for (int32_t rep : touched) {
      const int common = cnt[(size_t)rep];
      const int size_qry = (int)param_sizes[rep];  // PARAM size
      if (fast) {
        if (common < fixed_common_min) continue;
        if (common > best_common) {  // strict: first touch wins ties
          best_common = common;
          best_rep = rep;
        }
        continue;
      }
      int common_min;
      if (is_containment) {
        common_min = (int)std::ceil(jaccard_min * std::min(size_ref,
                                                           size_qry));
      } else {
        common_min = (int)std::ceil(jaccard_min * (size_ref + size_qry) /
                                    (1.0 + jaccard_min));
      }
      if (common < common_min) continue;
      double dist;
      if (is_containment) {
        const int min_size = std::min(size_ref, size_qry);
        if (min_size == 0) {
          dist = 1.0;
        } else {
          const double jac = (double)common / min_size;
          if (jac >= 1.0) dist = 0.0;
          else if (jac <= 0.0) dist = 1.0;
          else {
            dist = -std::log(2.0 * jac / (1.0 + jac)) / kmer_size;
            if (dist > 1.0) dist = 1.0;
          }
        }
      } else {
        const int denom = size_ref + size_qry - common;
        if (denom == 0) {
          dist = 0.0;
        } else {
          const double jac = (double)common / denom;
          if (jac >= 1.0) dist = 0.0;
          else if (jac <= 0.0) dist = 1.0;
          else {
            dist = -std::log(2.0 * jac / (1.0 + jac)) / kmer_size;
            if (dist > 1.0) dist = 1.0;
          }
        }
      }
      if (dist <= threshold && dist < best_dist) {
        best_dist = dist;
        best_rep = rep;
      }
    }

    out_best[j] = best_rep;
    if (best_rep == -1) add_rep(j);
  }
}

}  // extern "C"

// ---- native thresholded-pair engine ----------------------------------------
// Emits (i, j, common) for every pair sharing >= 1 hash that passes the
// integer prefilters: common >= ceil(j_min*(sA+sB)/(1+j_min)) and
// (optional) max <= ratio2 * min.  Same inverted-index + epoch-stamped
// accumulation skeleton as the MST engine; the caller computes float64
// distances host-side (identical results to the NumPy candidate path,
// which shares the counting semantics).  Used by the Leiden/DBSCAN graph
// builders where instance-expansion in NumPy explodes on dense clusters.

namespace {

struct PairsOut {
  std::vector<int32_t> pi, pj;
  std::vector<int32_t> common;
};

template <typename HashT>
PairsOut pairs_engine(const HashT* flat, const int64_t* offs, int64_t n,
                      double j_min, int ratio2, int64_t start_index,
                      int threads) {
  PairsOut out;
  if (n < 2) return out;
  const int64_t m = offs[n];
  std::vector<std::pair<HashT, uint32_t>> hv(m);
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t g = 0; g < n; ++g)
    for (int64_t p = offs[g]; p < offs[g + 1]; ++p)
      hv[p] = {flat[p], (uint32_t)g};
  if (threads > 1) __gnu_parallel::sort(hv.begin(), hv.end());
  else std::sort(hv.begin(), hv.end());
  std::vector<int64_t> run_start(m);
  for (int64_t p = 0; p < m; ++p)
    run_start[p] = (p > 0 && hv[p].first == hv[p - 1].first)
                       ? run_start[p - 1] : p;
  std::vector<int64_t> gcount(n + 1, 0);
  for (int64_t p = 0; p < m; ++p) gcount[hv[p].second + 1]++;
  for (int64_t g = 0; g < n; ++g) gcount[g + 1] += gcount[g];
  std::vector<int64_t> gpos(m);
  {
    std::vector<int64_t> cur(gcount.begin(), gcount.end() - 1);
    for (int64_t p = 0; p < m; ++p) gpos[cur[hv[p].second]++] = p;
  }

  std::vector<PairsOut> touts(threads);

#pragma omp parallel num_threads(threads)
  {
    int tid = omp_get_thread_num();
    auto& t = touts[tid];
    std::vector<int32_t> inter(n, 0), stamp(n, 0), touched;
    int32_t epoch = 0;
    touched.reserve(4096);

#pragma omp for schedule(dynamic, 8)
    for (int64_t i = start_index; i < n; ++i) {
      const int64_t size0 = offs[i + 1] - offs[i];
      if (size0 == 0) continue;
      touched.clear();
      if (++epoch == INT32_MAX) {
        std::fill(stamp.begin(), stamp.end(), 0);
        epoch = 1;
      }
      for (int64_t q = gcount[i]; q < gcount[i + 1]; ++q) {
        int64_t p = gpos[q];
        for (int64_t r = run_start[p]; r < m && hv[r].first == hv[p].first;
             ++r) {
          int32_t cur = (int32_t)hv[r].second;
          if (cur >= i) break;  // only j < i
          if (stamp[cur] != epoch) {
            stamp[cur] = epoch;
            inter[cur] = 1;
            touched.push_back(cur);
          } else {
            inter[cur]++;
          }
        }
      }
      for (int32_t j : touched) {
        const int64_t size1 = offs[j + 1] - offs[j];
        if (size1 == 0) continue;
        const int64_t mn = size0 < size1 ? size0 : size1;
        const int64_t mx = size0 > size1 ? size0 : size1;
        if (ratio2 > 0 && mx > (int64_t)ratio2 * mn) continue;
        const int32_t c = inter[j];
        if (j_min > 0.0 &&
            (double)c < std::ceil(j_min * (double)(size0 + size1) /
                                  (1.0 + j_min)))
          continue;
        t.pi.push_back(j);          // emit i < j convention: (j, i)
        t.pj.push_back((int32_t)i);
        t.common.push_back(c);
      }
    }
  }
  size_t total = 0;
  for (auto& t : touts) total += t.pi.size();
  out.pi.reserve(total);
  out.pj.reserve(total);
  out.common.reserve(total);
  for (auto& t : touts) {
    out.pi.insert(out.pi.end(), t.pi.begin(), t.pi.end());
    out.pj.insert(out.pj.end(), t.pj.begin(), t.pj.end());
    out.common.insert(out.common.end(), t.common.begin(), t.common.end());
  }
  return out;
}

}  // namespace

extern "C" {

void* rtc_pairs_u32(const uint32_t* flat, const int64_t* offs, int64_t n,
                    double j_min, int ratio2, int64_t start_index,
                    int threads) {
  return new PairsOut(pairs_engine<uint32_t>(flat, offs, n, j_min, ratio2,
                                             start_index, threads));
}
void* rtc_pairs_u64(const uint64_t* flat, const int64_t* offs, int64_t n,
                    double j_min, int ratio2, int64_t start_index,
                    int threads) {
  return new PairsOut(pairs_engine<uint64_t>(flat, offs, n, j_min, ratio2,
                                             start_index, threads));
}
int64_t rtc_pairs_count(void* h) { return (int64_t)((PairsOut*)h)->pi.size(); }
void rtc_pairs_data(void* h, int32_t* pi, int32_t* pj, int32_t* common) {
  PairsOut* o = (PairsOut*)h;
  memcpy(pi, o->pi.data(), o->pi.size() * 4);
  memcpy(pj, o->pj.data(), o->pj.size() * 4);
  memcpy(common, o->common.data(), o->common.size() * 4);
}
void rtc_pairs_free(void* h) { delete (PairsOut*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Reference-parity unstable sort (behavioral spec: src/greedy.cpp:594-597).
// The reference KSSD greedy sorts sketches with std::sort and a SIZE-ONLY
// comparator — tie order is whatever libstdc++ introsort produces for the
// given input sequence.  Since this library is compiled with the same
// libstdc++, calling the real std::sort with the same comparator-outcome
// sequence reproduces the permutation bit-for-bit (introsort's swap
// sequence depends only on comparison outcomes and element count, not on
// the element type).  out_perm[k] = original id at sorted position k.

extern "C" void rtc_stdsort_size_desc(const int64_t* sizes, int64_t n,
                                      int32_t* out_perm) {
  struct Rec {
    int64_t size;
    int32_t id;
  };
  std::vector<Rec> v((size_t)n);
  for (int64_t i = 0; i < n; ++i) v[i] = {sizes[i], (int32_t)i};
  std::sort(v.begin(), v.end(),
            [](const Rec& a, const Rec& b) { return a.size > b.size; });
  for (int64_t i = 0; i < n; ++i) out_perm[i] = v[i].id;
}


// ---------------------------------------------------------------------------
// Gated exact verify + union-find merge for proposal batches (the host side
// of the labelprop Boruvka rounds, ops/labelprop.py).  One native pass
// replaces: count_common dispatch + NumPy distance + Python merge loop.
// Distances are float64 with libm log (same as the native MST engine,
// MST.cpp:514-540 parity); union-find is path-compressed + union-by-rank on
// the caller's arrays — identical semantics to cluster/union_find.py, so
// Python code can keep using the same state between calls.
// Returns the number of KEPT edges (verified pass + endpoints previously
// disconnected), appended to out_i/out_j/out_d in input pair order.

namespace {

static int64_t uf_find(int64_t* parent, int64_t x) {
  int64_t root = x;
  while (parent[root] != root) root = parent[root];
  while (parent[x] != root) {
    int64_t nxt = parent[x];
    parent[x] = root;
    x = nxt;
  }
  return root;
}

template <typename T>
int64_t verify_merge_engine(const T* flat, const int64_t* offs,
                            const int64_t* ii, const int64_t* jj, int64_t m,
                            const int64_t* sizes, double threshold,
                            int kmer_size, int is_containment,
                            int64_t* parent, int8_t* rank_, int64_t* out_i,
                            int64_t* out_j, double* out_d, uint8_t* ok_out,
                            int threads) {
  std::vector<int32_t> common((size_t)m);
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t p = 0; p < m; ++p) {
    const T* a = flat + offs[ii[p]];
    const T* ae = flat + offs[ii[p] + 1];
    const T* b = flat + offs[jj[p]];
    const T* be = flat + offs[jj[p] + 1];
    int32_t c = 0;
    while (a < ae && b < be) {
      T x = *a, y = *b;
      c += (x == y);
      a += (x <= y);
      b += (y <= x);
    }
    common[(size_t)p] = c;
  }
  const double inv_k = 1.0 / (double)kmer_size;
  int64_t kept = 0;
  for (int64_t p = 0; p < m; ++p) {
    ok_out[p] = 0;
    int32_t c = common[(size_t)p];
    if (c <= 0) continue;
    double s0 = (double)sizes[ii[p]];
    double s1 = (double)sizes[jj[p]];
    double d;
    if (is_containment) {
      double mn = s0 < s1 ? s0 : s1;
      double cc = mn == 0.0 ? 0.0 : (double)c / mn;
      if (cc >= 1.0) d = 0.0;
      else if (cc <= 0.0) d = 1.0;
      else d = -inv_k * std::log(cc);
    } else {
      double denom = s0 + s1 - (double)c;
      double j = denom == 0.0 ? 0.0 : (double)c / denom;
      if (j >= 1.0) d = 0.0;
      else if (j <= 0.0) d = 1.0;
      else d = -inv_k * std::log(2.0 * j / (1.0 + j));
    }
    if (d > threshold) continue;
    ok_out[p] = 1;  // verified pass (gated-or-kept; failures stay 0)
    int64_t ra = uf_find(parent, ii[p]);
    int64_t rb = uf_find(parent, jj[p]);
    if (ra == rb) continue;
    if (rank_[ra] < rank_[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    if (rank_[ra] == rank_[rb]) ++rank_[ra];
    out_i[kept] = ii[p];
    out_j[kept] = jj[p];
    out_d[kept] = d;
    ++kept;
  }
  return kept;
}

}  // namespace

extern "C" {

int64_t rtc_verify_merge_u32(const uint32_t* flat, const int64_t* offs,
                             const int64_t* ii, const int64_t* jj, int64_t m,
                             const int64_t* sizes, double threshold,
                             int kmer_size, int is_containment,
                             int64_t* parent, int8_t* rank_, int64_t* out_i,
                             int64_t* out_j, double* out_d, uint8_t* ok_out,
                             int threads) {
  return verify_merge_engine<uint32_t>(flat, offs, ii, jj, m, sizes,
                                       threshold, kmer_size, is_containment,
                                       parent, rank_, out_i, out_j, out_d,
                                       ok_out, threads);
}

int64_t rtc_verify_merge_u64(const uint64_t* flat, const int64_t* offs,
                             const int64_t* ii, const int64_t* jj, int64_t m,
                             const int64_t* sizes, double threshold,
                             int kmer_size, int is_containment,
                             int64_t* parent, int8_t* rank_, int64_t* out_i,
                             int64_t* out_j, double* out_d, uint8_t* ok_out,
                             int threads) {
  return verify_merge_engine<uint64_t>(flat, offs, ii, jj, m, sizes,
                                       threshold, kmer_size, is_containment,
                                       parent, rank_, out_i, out_j, out_d,
                                       ok_out, threads);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Parallel CSR flatten: gather a list of per-genome hash arrays into one
// contiguous buffer (the CsrSketches constructor's np.concatenate, which
// costs ~2 s at 131k genomes on this box).  Pure memcpy, OpenMP over
// genomes; offsets are prefix sums computed by the caller.

extern "C" void rtc_flatten(const uint64_t* ptrs, const int64_t* offs,
                            int64_t n, int64_t elem_size, char* out,
                            int threads) {
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t g = 0; g < n; ++g) {
    int64_t cnt = offs[g + 1] - offs[g];
    memcpy(out + offs[g] * elem_size, (const void*)ptrs[g],
           (size_t)(cnt * elem_size));
  }
}

// ---------------------------------------------------------------------------
// Forest -> clusters finish (cluster/mst.py clusters_from_forest): BFS over
// forest adjacency in EDGE ORDER from the lowest unvisited id — the
// reference member-order contract (MST.cpp:109-142).  Returns the number
// of clusters; order_out lists genome ids in discovery order, bounds_out
// delimits clusters (bounds_out[k] .. bounds_out[k+1]).

extern "C" int64_t rtc_forest_clusters(const int64_t* ei, const int64_t* ej,
                                       int64_t m, int64_t n,
                                       int32_t* order_out,
                                       int64_t* bounds_out) {
  std::vector<int64_t> deg(n + 1, 0);
  for (int64_t k = 0; k < m; ++k) {
    ++deg[ei[k] + 1];
    ++deg[ej[k] + 1];
  }
  for (int64_t v = 0; v < n; ++v) deg[v + 1] += deg[v];
  std::vector<int32_t> nbr(2 * (size_t)m);
  std::vector<int64_t> fill(deg.begin(), deg.end() - 1);
  for (int64_t k = 0; k < m; ++k) {  // edge order = python append order
    nbr[(size_t)fill[ei[k]]++] = (int32_t)ej[k];
    nbr[(size_t)fill[ej[k]]++] = (int32_t)ei[k];
  }
  std::vector<uint8_t> visited(n, 0);
  std::vector<int32_t> queue(n);
  int64_t w = 0, nc = 0;
  for (int64_t s = 0; s < n; ++s) {
    if (visited[s]) continue;
    bounds_out[nc++] = w;
    visited[s] = 1;
    int64_t qh = 0, qt = 0;
    queue[qt++] = (int32_t)s;
    order_out[w++] = (int32_t)s;
    while (qh < qt) {
      int32_t u = queue[qh++];
      for (int64_t p = deg[u]; p < deg[u + 1]; ++p) {
        int32_t v = nbr[(size_t)p];
        if (!visited[v]) {
          visited[v] = 1;
          queue[qt++] = v;
          order_out[w++] = v;
        }
      }
    }
  }
  bounds_out[nc] = w;
  return nc;
}

// ---------------------------------------------------------------------------
// Louvain / Leiden hot loops (cluster/leiden.py _one_level / _refine move
// phase).  Bit-identical to the NumPy reference implementation, which stays
// in leiden.py as the fallback and test oracle: same ascending node order,
// same first-occurrence community link order, and the same float64
// expression trees (no expression here is FMA-contractable except the
// exact 2.0*w multiply, so -ffp-contract makes no difference).  Parity
// target: igraph community_multilevel / community_leiden as invoked by the
// reference (/root/reference/src/leiden.cpp:367-400).

extern "C" int64_t rtc_louvain_one_level(
    int64_t n, const int64_t* adj_idx, const int64_t* adj_nbr,
    const double* adj_w, const double* k_arr, double two_m,
    double resolution, const int64_t* init, int64_t comm_tot_len,
    int64_t* comm) {
  std::vector<double> comm_tot((size_t)comm_tot_len, 0.0);
  if (init) {
    for (int64_t i = 0; i < n; ++i) comm[i] = init[i];
    for (int64_t i = 0; i < n; ++i) comm_tot[(size_t)comm[i]] += k_arr[i];
  } else {
    for (int64_t i = 0; i < n; ++i) comm[i] = i;
    for (int64_t i = 0; i < n; ++i) comm_tot[(size_t)i] = k_arr[i];
  }
  std::vector<int64_t> mark((size_t)comm_tot_len, -1);
  std::vector<int64_t> lcomm;
  std::vector<double> lw;
  int64_t improved_any = 0;
  for (int sweep = 0; sweep < 100; ++sweep) {
    int64_t moved = 0;
    for (int64_t u = 0; u < n; ++u) {
      int64_t b0 = adj_idx[u], b1 = adj_idx[u + 1];
      if (b1 == b0) continue;
      int64_t cu = comm[u];
      double ku = k_arr[u];
      comm_tot[(size_t)cu] -= ku;
      lcomm.clear();
      lw.clear();
      for (int64_t p = b0; p < b1; ++p) {
        int64_t cv = comm[adj_nbr[p]];
        int64_t ix = mark[(size_t)cv];
        if (ix < 0) {
          mark[(size_t)cv] = (int64_t)lcomm.size();
          lcomm.push_back(cv);
          lw.push_back(adj_w[p]);
        } else {
          lw[(size_t)ix] += adj_w[p];
        }
      }
      double w_cu = (mark[(size_t)cu] >= 0) ? lw[(size_t)mark[(size_t)cu]]
                                            : 0.0;
      double base = w_cu - resolution * comm_tot[(size_t)cu] * ku / two_m;
      int64_t best_c = cu;
      double best_gain = 0.0;
      for (size_t t = 0; t < lcomm.size(); ++t) {
        int64_t cv = lcomm[t];
        double gain = lw[t] - resolution * comm_tot[(size_t)cv] * ku / two_m;
        double rel = gain - base;
        if (rel > best_gain + 1e-12 ||
            (std::fabs(rel - best_gain) <= 1e-12 && best_gain > 0 &&
             cv < best_c)) {
          best_gain = rel;
          best_c = cv;
        }
      }
      for (size_t t = 0; t < lcomm.size(); ++t) mark[(size_t)lcomm[t]] = -1;
      comm[u] = best_c;
      comm_tot[(size_t)best_c] += ku;
      if (best_c != cu) {
        moved = 1;
        improved_any = 1;
      }
    }
    if (!moved) break;
  }
  return improved_any;
}

// Leiden refinement MOVE loop only; the caller (leiden.py _refine) computes
// ext / well_v / comm_tot with NumPy first (keeps NumPy's pairwise-sum FP
// order for E(v, C-v) out of native code).  ``ext`` is updated in place
// exactly like the Python loop; ``sub`` is the output membership.
extern "C" void rtc_leiden_refine_moves(
    int64_t n, const int64_t* adj_idx, const int64_t* adj_nbr,
    const double* adj_w, const double* k_arr, double two_m,
    const int64_t* comm, double resolution, const double* comm_tot,
    double* ext, const uint8_t* well_v, int64_t* sub) {
  std::vector<double> sub_tot(k_arr, k_arr + n);
  std::vector<int64_t> sub_size((size_t)n, 1);
  for (int64_t i = 0; i < n; ++i) sub[i] = i;
  std::vector<int64_t> mark((size_t)n, -1);
  std::vector<int64_t> lsub;
  std::vector<double> lw;
  for (int64_t u = 0; u < n; ++u) {
    if (sub_size[(size_t)sub[u]] != 1 || !well_v[u]) continue;
    int64_t cu = comm[u];
    lsub.clear();
    lw.clear();
    for (int64_t p = adj_idx[u]; p < adj_idx[u + 1]; ++p) {
      int64_t v = adj_nbr[p];
      if (comm[v] != cu) continue;
      int64_t sv = sub[v];
      if (sv == sub[u]) continue;
      int64_t ix = mark[(size_t)sv];
      if (ix < 0) {
        mark[(size_t)sv] = (int64_t)lsub.size();
        lsub.push_back(sv);
        lw.push_back(adj_w[p]);
      } else {
        lw[(size_t)ix] += adj_w[p];
      }
    }
    double ku = k_arr[u];
    int64_t best_s = -1;
    double best_gain = 0.0;
    for (size_t t = 0; t < lsub.size(); ++t) {
      int64_t sv = lsub[t];
      double ks = sub_tot[(size_t)sv];
      if (ext[sv] <
          resolution * ks * (comm_tot[(size_t)cu] - ks) / two_m)
        continue;
      double gain = lw[t] - resolution * ks * ku / two_m;
      if (gain > best_gain + 1e-12 ||
          (std::fabs(gain - best_gain) <= 1e-12 && best_gain > 0 &&
           sv < best_s)) {
        best_gain = gain;
        best_s = sv;
      }
    }
    if (best_s >= 0) {
      int64_t old = sub[u];
      double w_in = lw[(size_t)mark[(size_t)best_s]];
      sub[u] = best_s;
      sub_size[(size_t)old] -= 1;
      sub_size[(size_t)best_s] += 1;
      sub_tot[(size_t)best_s] += ku;
      sub_tot[(size_t)old] -= ku;
      ext[best_s] += ext[old] - 2.0 * w_in;
      ext[old] = 0.0;
    }
    for (size_t t = 0; t < lsub.size(); ++t) mark[(size_t)lsub[t]] = -1;
  }
}

// CSR adjacency for the Louvain level loop (cluster/leiden.py louvain /
// leiden): replicates np.argsort(concat(frm,to), stable) exactly via a
// two-pass counting sort — per node, frm-occurrences in edge order then
// to-occurrences in edge order — and deg_w in np.add.at order (all frm
// adds, then all to adds).
extern "C" void rtc_csr_build(int64_t n, int64_t m, const int64_t* frm,
                              const int64_t* to, const double* w,
                              int64_t* adj_idx, int64_t* adj_nbr,
                              double* adj_w, double* deg_w) {
  for (int64_t u = 0; u < n; ++u) deg_w[u] = 0.0;
  for (int64_t k = 0; k < m; ++k) deg_w[frm[k]] += w[k];
  for (int64_t k = 0; k < m; ++k) deg_w[to[k]] += w[k];
  for (int64_t u = 0; u <= n; ++u) adj_idx[u] = 0;
  for (int64_t k = 0; k < m; ++k) {
    ++adj_idx[frm[k] + 1];
    ++adj_idx[to[k] + 1];
  }
  for (int64_t u = 0; u < n; ++u) adj_idx[u + 1] += adj_idx[u];
  std::vector<int64_t> fill(adj_idx, adj_idx + n);
  for (int64_t k = 0; k < m; ++k) {
    int64_t s = fill[frm[k]]++;
    adj_nbr[s] = to[k];
    adj_w[s] = w[k];
  }
  for (int64_t k = 0; k < m; ++k) {
    int64_t s = fill[to[k]]++;
    adj_nbr[s] = frm[k];
    adj_w[s] = w[k];
  }
}

// ---------------------------------------------------------------------------
// Intra-partition MST replay (the byte-identical order finish for the device
// labelprop clusters path).  Given an exact threshold partition (labels),
// replays the -t 1 streaming-Kruskal cadence of mst_engine / the reference
// (MST.cpp:388-766: subSize=8 genome blocks by GLOBAL id, unstable
// dist-only std::sort + Kruskal per block, tail reduce, final reduce)
// restricted to WITHIN-cluster candidate pairs.  Candidate enumeration,
// first-touch order, ratio filter and libm-log distances are identical to
// mst_engine; cross-cluster candidates (all >= threshold by the partition
// definition) are the only edges absent from the sort arrays.  Cutting the
// result at the threshold therefore yields each cluster's spanning tree in
// the order generateClusterWithBfs consumes (MST.cpp:109-142); the 400- and
// 5k-genome goldens assert the .cluster files are byte-identical to the
// reference binary's.

namespace {

template <typename HashT>
MstOut intra_mst_engine(const HashT* flat, const int64_t* offs, int64_t n,
                        const int32_t* labels, double threshold,
                        int kmer_size, bool containment,
                        int32_t* has_cross, bool abort_on_cross) {
  MstOut out;
  if (has_cross) *has_cross = 0;
  if (n < 2) return out;
  const int64_t m = offs[n];
  // Exactness certificate: when NO hash value is shared across two
  // different labels, every genome's touched set (and hence the candidate
  // edge stream, the per-block sort arrays and all their unstable-tie
  // permutations) is IDENTICAL to the global engine's — the replay is
  // byte-identical to the -t 1 reference by construction.  When cross-
  // label sharing exists the replay is still the reference cadence over
  // the within-cluster stream, but equal-distance tie groups that
  // interleave with cross-cluster candidates in the global sort arrays
  // may resolve differently (measured: 128/4800 tie-substituted tree
  // edges on an adversarial synthetic corpus) — the flag lets callers
  // report which case they are in.
  if (has_cross) {
    std::vector<std::pair<HashT, int32_t>> hl(m);
    for (int64_t g = 0; g < n; ++g)
      for (int64_t p = offs[g]; p < offs[g + 1]; ++p)
        hl[p] = {flat[p], labels[g]};
    std::sort(hl.begin(), hl.end());
    for (int64_t p = 1; p < m; ++p)
      if (hl[p].first == hl[p - 1].first &&
          hl[p].second != hl[p - 1].second) {
        *has_cross = 1;
        break;
      }
    // caller will run the full global engine instead — skip the replay
    if (*has_cross && abort_on_cross) return out;
  }
  // (label, hash, gid) sort: runs = same (label, hash) -> the per-cluster
  // inverted index, gids ascending within a run
  struct Ent {
    int32_t label;
    HashT hash;
    uint32_t gid;
    bool operator<(const Ent& o) const {
      if (label != o.label) return label < o.label;
      if (hash != o.hash) return hash < o.hash;
      return gid < o.gid;
    }
  };
  std::vector<Ent> hv(m);
  for (int64_t g = 0; g < n; ++g)
    for (int64_t p = offs[g]; p < offs[g + 1]; ++p)
      hv[p] = {labels[g], flat[p], (uint32_t)g};
  std::sort(hv.begin(), hv.end());
  std::vector<int64_t> run_start(m);
  for (int64_t p = 0; p < m; ++p)
    run_start[p] = (p > 0 && hv[p].hash == hv[p - 1].hash &&
                    hv[p].label == hv[p - 1].label)
                       ? run_start[p - 1] : p;
  std::vector<int64_t> gcount(n + 1, 0);
  for (int64_t p = 0; p < m; ++p) gcount[hv[p].gid + 1]++;
  for (int64_t g = 0; g < n; ++g) gcount[g + 1] += gcount[g];
  std::vector<int64_t> gpos(m);
  {
    std::vector<int64_t> cur(gcount.begin(), gcount.end() - 1);
    for (int64_t p = 0; p < m; ++p) gpos[cur[hv[p].gid]++] = p;
  }

  const int radio = (int)(2.0 * std::exp(threshold * (kmer_size - 1)) - 1.0);
  const double inv_k = 1.0 / kmer_size;
  const int64_t sub_size = 8;
  const int64_t tail_n = n % sub_size;

  std::vector<EdgeRec> edges;
  std::vector<int32_t> inter(n, 0);
  std::vector<int32_t> stamp(n, 0);
  int32_t epoch = 0;
  std::vector<int32_t> touched;
  touched.reserve(4096);

  for (int64_t i = 0; i < n; ++i) {
    const int64_t size0 = offs[i + 1] - offs[i];
    if (size0 == 0) continue;
    touched.clear();
    if (++epoch == INT32_MAX) {
      std::fill(stamp.begin(), stamp.end(), 0);
      epoch = 1;
    }
    for (int64_t q = gcount[i]; q < gcount[i + 1]; ++q) {
      int64_t p = gpos[q];
      for (int64_t r = run_start[p];
           r < m && hv[r].hash == hv[p].hash && hv[r].label == hv[p].label;
           ++r) {
        int32_t cur = (int32_t)hv[r].gid;
        if (cur >= i) break;  // gid ascending within run; only j < i
        if (stamp[cur] != epoch) {
          stamp[cur] = epoch;
          inter[cur] = 1;
          touched.push_back(cur);
        } else {
          inter[cur]++;
        }
      }
    }
    for (int32_t j : touched) {
      const int64_t size1 = offs[j + 1] - offs[j];
      if (size1 == 0) continue;
      const int64_t mn = size0 < size1 ? size0 : size1;
      const int64_t mx = size0 > size1 ? size0 : size1;
      if (mx > (int64_t)radio * mn) continue;
      const int32_t common = inter[j];
      double dist;
      if (!containment) {
        const int64_t denom = size0 + size1 - common;
        double jac = denom == 0 ? 0.0 : (double)common / (double)denom;
        if (jac == 1.0) dist = 0.0;
        else if (jac == 0.0) dist = 1.0;
        else dist = -inv_k * std::log(2.0 * jac / (1.0 + jac));
      } else {
        double c = mn == 0 ? 0.0 : (double)common / (double)mn;
        if (c == 1.0) dist = 0.0;
        else if (c == 0.0) dist = 1.0;
        else dist = -inv_k * std::log(c);
      }
      edges.push_back({(int32_t)i, j, dist});
    }
    if (i < n - tail_n && (i + 1) % sub_size == 0)
      kruskal_reduce_parity(edges, (int)n);
  }
  if (tail_n > 0 && !edges.empty()) kruskal_reduce_parity(edges, (int)n);
  kruskal_reduce_parity(edges, (int)n);
  out.ei.reserve(edges.size());
  out.ej.reserve(edges.size());
  out.ed.reserve(edges.size());
  for (auto& e : edges) {
    out.ei.push_back(e.i);
    out.ej.push_back(e.j);
    out.ed.push_back(e.d);
  }
  return out;
}

}  // namespace

extern "C" void* rtc_intra_mst_u32(const uint32_t* flat, const int64_t* offs,
                                   int64_t n, const int32_t* labels,
                                   double threshold, int kmer_size,
                                   int containment, int32_t* has_cross,
                                   int abort_on_cross) {
  return new MstOut(intra_mst_engine<uint32_t>(flat, offs, n, labels,
                                               threshold, kmer_size,
                                               containment != 0, has_cross,
                                               abort_on_cross != 0));
}
extern "C" void* rtc_intra_mst_u64(const uint64_t* flat, const int64_t* offs,
                                   int64_t n, const int32_t* labels,
                                   double threshold, int kmer_size,
                                   int containment, int32_t* has_cross,
                                   int abort_on_cross) {
  return new MstOut(intra_mst_engine<uint64_t>(flat, offs, n, labels,
                                               threshold, kmer_size,
                                               containment != 0, has_cross,
                                               abort_on_cross != 0));
}

// Parallel in-place u64 sort (save_kssd_index posting keys; numpy's
// single-threaded sort costs ~0.3 s at 4M postings on this box).
extern "C" void rtc_sort_u64(uint64_t* arr, int64_t n, int threads) {
  omp_set_num_threads(threads > 0 ? threads : omp_get_max_threads());
  __gnu_parallel::sort(arr, arr + n);
}

// Posting-key pack/unpack for save_kssd_index (the numpy temporaries cost
// ~0.45 s at 4M postings; these + rtc_sort_u64 replace them).
extern "C" void rtc_pack_postings_u32(const uint32_t* flat,
                                      const int64_t* offs, int64_t n,
                                      uint64_t* key, int threads) {
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t g = 0; g < n; ++g)
    for (int64_t p = offs[g]; p < offs[g + 1]; ++p)
      key[p] = ((uint64_t)flat[p] << 32) | (uint64_t)(uint32_t)g;
}
extern "C" void rtc_unpack_postings_u32(const uint64_t* key, int64_t m,
                                        uint32_t* hv, uint32_t* gid,
                                        int threads) {
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t p = 0; p < m; ++p) {
    hv[p] = (uint32_t)(key[p] >> 32);
    gid[p] = (uint32_t)key[p];
  }
}
