// bz2tpu host runtime: the serial, latency-bound pieces of the codec that a
// TPU is the wrong tool for.  Everything here is a from-scratch
// implementation of the .bz2 format semantics (documented against the
// reference in bzip2_tpu/oracle/*.py); no reference code is used.
//
//   * bz2tpu_make_code_lengths  — batched reference-exact Huffman length
//     construction (heap discipline documented in oracle/huffman.py),
//     called by the hybrid TPU encode path between device stages.
//   * bz2tpu_decompress         — complete .bz2 stream decoder (header
//     parse, canonical Huffman w/ fast first-bits table, MTF/RLE2, inverse
//     BWT, RLE1, both CRC layers, multi-stream + trailing garbage).
//   * bz2tpu_crc32              — CRC-32/BZIP2 (slice-by-8).
//   * bz2tpu_rle1_split         — RLE1 pre-pass + block split.
//   * bz2tpu_encode_block       — complete native block encoder (SA-IS
//     rotation sort, MTF/RLE2, greedy 6-table search, exact Huffman, bit
//     packing) — the host worker / no-JAX fast path.
//
// Build: g++ -O3 -shared -fPIC (see build.py).  ABI: plain C, ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <immintrin.h>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <new>
#include <type_traits>
#include <vector>
#include <sys/mman.h>

// Hint THP for a big random-access buffer: on this VM class a 2MB fault
// costs the same as a 4K one (~100x cheaper first touch), and the dTLB
// stops thrashing on multi-MB pointer-chase tables.
static inline void advise_huge(void* ptr, size_t len) {
#ifdef MADV_HUGEPAGE
  uintptr_t a = ((uintptr_t)ptr + ((2u << 20) - 1)) & ~(uintptr_t)((2u << 20) - 1);
  uintptr_t end = ((uintptr_t)ptr + len) & ~(uintptr_t)((2u << 20) - 1);
  if (end > a) madvise((void*)a, end - a, MADV_HUGEPAGE);
#endif
}

extern "C" {

typedef uint8_t  u8;
typedef uint16_t u16;
typedef int16_t  i16;
typedef uint32_t u32;
typedef uint64_t u64;
typedef int32_t  i32;
typedef int64_t  i64;

// ---------------------------------------------------------------- errors --
enum {
  BZT_OK = 0,
  BZT_STREAM_END = 4,
  BZT_DATA_ERROR = -4,
  BZT_DATA_ERROR_MAGIC = -5,
  BZT_UNEXPECTED_EOF = -7,
  BZT_OUTBUFF_FULL = -8,
  BZT_MEM_ERROR = -3,
};

// ------------------------------------------------------------------- CRC --
static u32 g_crc_tab[8][256];
static bool g_crc_init = false;

static void crc_init() {
  if (g_crc_init) return;
  for (u32 i = 0; i < 256; i++) {
    u32 c = i << 24;
    for (int k = 0; k < 8; k++)
      c = (c & 0x80000000u) ? (c << 1) ^ 0x04c11db7u : (c << 1);
    g_crc_tab[0][i] = c;
  }
  for (int s = 1; s < 8; s++)
    for (u32 i = 0; i < 256; i++) {
      u32 prev = g_crc_tab[s - 1][i];
      g_crc_tab[s][i] = (prev << 8) ^ g_crc_tab[0][prev >> 24];
    }
  g_crc_init = true;
}

static inline u32 crc_byte(u32 crc, u8 b) {
  return (crc << 8) ^ g_crc_tab[0][(crc >> 24) ^ b];
}

// slice-by-8 update, no init/finalise (callers manage the 0xffffffff wrap)
static u32 crc_update(u32 c, const u8* data, i64 n) {
  i64 i = 0;
  for (; i + 8 <= n; i += 8) {
    u32 hi = (u32(data[i]) << 24) | (u32(data[i + 1]) << 16) |
             (u32(data[i + 2]) << 8) | u32(data[i + 3]);
    hi ^= c;
    c = g_crc_tab[7][hi >> 24] ^ g_crc_tab[6][(hi >> 16) & 0xff] ^
        g_crc_tab[5][(hi >> 8) & 0xff] ^ g_crc_tab[4][hi & 0xff] ^
        g_crc_tab[3][data[i + 4]] ^ g_crc_tab[2][data[i + 5]] ^
        g_crc_tab[1][data[i + 6]] ^ g_crc_tab[0][data[i + 7]];
  }
  for (; i < n; i++) c = crc_byte(c, data[i]);
  return c;
}

u32 bz2tpu_crc32(const u8* data, i64 n) {
  crc_init();
  return ~crc_update(0xffffffffu, data, n);
}

// ------------------------------------------------- Huffman length builder --
// Reference-exact discipline: packed keys (weight<<8)|depth, strict-< sift
// up, sift down taking the right child only when strictly smaller,
// insertion order 1..alpha, parent (w1+w2)|(1+max(d1,d2)), halve+retry when
// depth > max_len.  See oracle/huffman.py for the semantic contract.
static void huff_lengths_one(const i32* freq, i32 alpha, i32 max_len,
                             i32* out_len) {
  i32 weight[258 * 2 + 2];
  i32 parent[258 * 2 + 2];
  i32 heap[258 + 2];
  i32 leaf[258 + 1];

  for (i32 i = 0; i < alpha; i++)
    leaf[i + 1] = (freq[i] ? freq[i] : 1) << 8;

  for (;;) {
    i32 n_nodes = alpha, n_heap = 0;
    heap[0] = 0;
    weight[0] = 0;
    parent[0] = -2;
    for (i32 i = 1; i <= alpha; i++) weight[i] = leaf[i];

    for (i32 i = 1; i <= alpha; i++) {
      parent[i] = -1;
      n_heap++;
      i32 zz = n_heap;
      while (weight[i] < weight[heap[zz >> 1]]) {
        heap[zz] = heap[zz >> 1];
        zz >>= 1;
      }
      heap[zz] = i;
    }

    while (n_heap > 1) {
      i32 picked[2];
      for (int r = 0; r < 2; r++) {
        picked[r] = heap[1];
        i32 tmp = heap[n_heap--];
        i32 zz = 1;
        for (;;) {
          i32 yy = zz << 1;
          if (yy > n_heap) break;
          if (yy < n_heap && weight[heap[yy + 1]] < weight[heap[yy]]) yy++;
          if (weight[tmp] < weight[heap[yy]]) break;
          heap[zz] = heap[yy];
          zz = yy;
        }
        heap[zz] = tmp;
      }
      i32 nn = ++n_nodes;
      parent[picked[0]] = parent[picked[1]] = nn;
      i32 w1 = weight[picked[0]], w2 = weight[picked[1]];
      i32 d1 = w1 & 0xff, d2 = w2 & 0xff;
      weight[nn] = ((w1 & ~0xff) + (w2 & ~0xff)) | (1 + (d1 > d2 ? d1 : d2));
      parent[nn] = -1;
      i32 zz = ++n_heap;
      while (weight[nn] < weight[heap[zz >> 1]]) {
        heap[zz] = heap[zz >> 1];
        zz >>= 1;
      }
      heap[zz] = nn;
    }

    bool too_long = false;
    for (i32 i = 1; i <= alpha; i++) {
      i32 d = 0, k = i;
      while (parent[k] >= 0) { k = parent[k]; d++; }
      out_len[i - 1] = d;
      if (d > max_len) too_long = true;
    }
    if (!too_long) return;
    for (i32 i = 1; i <= alpha; i++)
      leaf[i] = (1 + ((leaf[i] >> 8) / 2)) << 8;
  }
}

// freqs: L x 258 row-major; alphas: L; out: L x 258.
void bz2tpu_make_code_lengths(const i32* freqs, const i32* alphas, i32 lanes,
                              i32 max_len, i32* out) {
  for (i32 l = 0; l < lanes; l++) {
    huff_lengths_one(freqs + (i64)l * 258, alphas[l], max_len,
                     out + (i64)l * 258);
  }
}

// --------------------------------------------------------------- decoder --
struct BitRd {
  const u8* p;
  const u8* end;
  u64 buf = 0;
  int n = 0;  // valid low bits of buf

  bool fill() {
    // bulk refill: 32 bits at a time while 4+ input bytes remain
    while (n <= 32 && end - p >= 4) {
      u32 w;
      memcpy(&w, p, 4);
      buf = (buf << 32) | __builtin_bswap32(w);
      p += 4;
      n += 32;
    }
    while (n <= 56 && p < end) { buf = (buf << 8) | *p++; n += 8; }
    return n > 0;
  }
  // peek up to 32 bits (zero-padded past EOF).  The mask must be built
  // in 64-bit: k == 32 (the stream-header peek) makes (1u << k) UB, and
  // PGO'd builds really did miscompile it (plain -O3 got lucky).
  inline u32 peek(int k) {
    const u32 mask = (u32)(((u64)1 << k) - 1);
    if (n < k) fill();
    if (n >= k) return (u32)(buf >> (n - k)) & mask;
    // past EOF: pad with zeros
    return (u32)(buf << (k - n)) & mask;
  }
  inline bool have(int k) {
    if (n < k) fill();
    return n >= k;
  }
  inline void drop(int k) { n -= k; }
  inline i64 bit_pos(const u8* base) const { return (p - base) * 8 - n; }
};

struct Group {
  i32 limit[25];   // max code value per length
  i32 base[25];    // code - base = perm index
  i32 min_len, max_len;
  i16 perm[258];
  // fast table: FAST_BITS-wide prefix -> -1 slow path, else bit0 = pair
  // flag, bits[1:5) l1, [5:9) l2, [9:18) sym1, [18:27) sym2 (a pair entry
  // decodes two complete codes per lookup)
  enum { FAST_BITS = 12 };
  i32 fast[1 << FAST_BITS];
};

static bool build_group(Group& g, const u8* lens, i32 alpha) {
  i32 cnt[25];
  memset(cnt, 0, sizeof cnt);
  g.min_len = 24; g.max_len = 0;
  for (i32 i = 0; i < alpha; i++) {
    i32 l = lens[i];
    if (l < 1 || l > 23) return false;
    cnt[l]++;
    if (l < g.min_len) g.min_len = l;
    if (l > g.max_len) g.max_len = l;
  }
  // canonical perm: stable by (length, symbol)
  i32 idx[25];
  i32 acc = 0;
  for (i32 l = g.min_len; l <= g.max_len; l++) { idx[l] = acc; acc += cnt[l]; }
  for (i32 i = 0; i < alpha; i++) g.perm[idx[lens[i]]++] = (i16)i;
  // limits/bases + Kraft completeness
  i64 code = 0, total = 0;
  u64 kraft = 0;
  for (i32 l = g.min_len; l <= g.max_len; l++) {
    g.base[l] = (i32)(code - total);
    code += cnt[l];
    total += cnt[l];
    g.limit[l] = (i32)(code - 1);
    kraft += (u64)cnt[l] << (g.max_len - l);
    code <<= 1;
  }
  if (kraft != (1ull << g.max_len)) return false;
  // fast table
  for (i32 v = 0; v < (1 << Group::FAST_BITS); v++) g.fast[v] = -1;
  i64 c2 = 0;
  i32 pi = 0;
  for (i32 l = g.min_len; l <= g.max_len; l++) {
    if (l > Group::FAST_BITS) break;
    for (i32 k = 0; k < cnt[l]; k++, pi++, c2++) {
      i32 lo = (i32)(c2 << (Group::FAST_BITS - l));
      i32 hi = lo + (1 << (Group::FAST_BITS - l));
      for (i32 v = lo; v < hi; v++) g.fast[v] = (g.perm[pi] << 5) | l;
    }
    c2 <<= 1;
  }
  // pair pass: when the window provably holds two complete codes, one
  // lookup decodes both.  Final encoding: -1 slow; else bit0 = pair flag,
  // bits[1:5) l1, [5:9) l2, [9:18) sym1, [18:27) sym2.  sym1 == EOB is
  // kept single so the decoder never consumes bits past the block end.
  {
    i32 tmp[1 << Group::FAST_BITS];
    const i32 mask = (1 << Group::FAST_BITS) - 1;
    i32 eob = alpha - 1;
    for (i32 v = 0; v <= mask; v++) {
      i32 f = g.fast[v];
      if (f < 0) { tmp[v] = -1; continue; }
      i32 l1 = f & 31, s1 = f >> 5;
      i32 e = (l1 << 1) | (s1 << 9);
      if (s1 != eob && l1 < Group::FAST_BITS) {
        i32 f2 = g.fast[(v << l1) & mask];
        if (f2 >= 0 && (f2 & 31) <= Group::FAST_BITS - l1)
          e |= 1 | ((f2 & 31) << 5) | ((f2 >> 5) << 18);
      }
      tmp[v] = e;
    }
    memcpy(g.fast, tmp, sizeof tmp);
  }
  return true;
}

struct OutBuf {
  u8* p = nullptr;
  i64 len = 0, cap = 0;
  bool grow(i64 need) {
    if (len + need <= cap) return true;
    i64 nc = cap ? cap : (1 << 20);
    while (nc < len + need) nc *= 2;
    u8* np = (u8*)realloc(p, nc);
    if (!np) return false;
    p = np; cap = nc;
    return true;
  }
};

// Randomisation schedule for legacy streams; table injected from Python
// (format-mandated constants, see bzip2_tpu/rand_table.py).
static i32 g_rnums[512];
static bool g_rnums_set = false;
void bz2tpu_set_rnums(const i32* r) {
  memcpy(g_rnums, r, sizeof g_rnums);
  g_rnums_set = true;
}

struct RandState {
  i32 n_to_go = 0, idx = 0;
  inline int next_mask() {
    if (n_to_go == 0) { n_to_go = g_rnums[idx]; idx = (idx + 1) & 511; }
    n_to_go--;
    return n_to_go == 1 ? 1 : 0;
  }
};

#define NEED(k) do { if (!br.have(k)) return BZT_UNEXPECTED_EOF; } while (0)
#define GET(v, k) do { NEED(k); v = br.peek(k); br.drop(k); } while (0)

// Decode one block body (after the 48-bit block magic has been consumed).
// Appends the block's raw bytes to ob and folds its CRC into *combined.
// Returns BZT_OK / BZT_DATA_ERROR / BZT_UNEXPECTED_EOF / BZT_MEM_ERROR.
static double g_dec_t[5];
static i64 g_dec_pairs, g_dec_singles, g_dec_slow;
static void dec_lap(int k, struct timespec* t0) {
  if (!getenv("BZ2TPU_DEBUG_TIMING")) return;
  struct timespec t1;
  clock_gettime(CLOCK_MONOTONIC, &t1);
  g_dec_t[k] += (t1.tv_sec - t0->tv_sec) + 1e-9 * (t1.tv_nsec - t0->tv_nsec);
  *t0 = t1;
}
void bz2tpu_dump_dec_timing() {
  if (!getenv("BZ2TPU_DEBUG_TIMING")) return;
  fprintf(stderr,
          "[dec] hdr %.3fs  huff/mtf %.3fs  ibwt-build %.3fs  chase %.3fs  "
          "expand+crc %.3fs  pairs %lld singles %lld slow %lld\n",
          g_dec_t[0], g_dec_t[1], g_dec_t[2], g_dec_t[3], g_dec_t[4],
          (long long)g_dec_pairs, (long long)g_dec_singles,
          (long long)g_dec_slow);
  memset(g_dec_t, 0, sizeof g_dec_t);
  g_dec_pairs = g_dec_singles = g_dec_slow = 0;
}

// Split block decode: a bit-serial symbol phase and a memory-bound chain
// walk.  The one-shot stream decoder pairs two blocks and interleaves
// their walks (two independent dependency chains hide the LLC latency of
// the tt pointer chase).
struct BlockSym { i32 n; u32 stored_crc; u32 randomised; u32 orig_ptr; };

static i32 decode_block_symbols(BitRd& br, i32 max_block, u8* blk,
                                i32* cftab, BlockSym& bs) {
  u32 stored_crc, w;
  GET(stored_crc, 16); GET(w, 16);
  stored_crc = (stored_crc << 16) | w;
  u32 randomised; GET(randomised, 1);
  if (randomised && !g_rnums_set) return BZT_DATA_ERROR;
  u32 orig_ptr; GET(orig_ptr, 24);
  if ((i32)orig_ptr > max_block) return BZT_DATA_ERROR;

  // symbol map
  u8 used[256];
  i32 n_used = 0;
  u32 gmask; GET(gmask, 16);
  for (i32 gi = 0; gi < 16; gi++) {
    if (gmask & (0x8000u >> gi)) {
      u32 bits; GET(bits, 16);
      for (i32 j = 0; j < 16; j++)
        if (bits & (0x8000u >> j)) used[n_used++] = (u8)(gi * 16 + j);
    }
  }
  if (n_used == 0) return BZT_DATA_ERROR;
  i32 alpha = n_used + 2, eob = n_used + 1;

  u32 n_groups, n_selectors;
  GET(n_groups, 3); GET(n_selectors, 15);
  if (n_groups < 2 || n_groups > 6) return BZT_DATA_ERROR;
  if (n_selectors < 1 || n_selectors > 18002) return BZT_DATA_ERROR;  // CVE-2010-0405

  u8 selectors[18002];
  for (u32 i = 0; i < n_selectors; i++) {
    i32 v = 0;
    for (;;) {
      u32 b; GET(b, 1);
      if (!b) break;
      if (++v >= (i32)n_groups) return BZT_DATA_ERROR;
    }
    selectors[i] = (u8)v;
  }
  {  // un-MTF in place (read-before-write per index)
    u8 pos[6] = {0, 1, 2, 3, 4, 5};
    for (u32 i = 0; i < n_selectors; i++) {
      i32 v = selectors[i];
      u8 tmp = pos[v];
      for (; v > 0; v--) pos[v] = pos[v - 1];
      pos[0] = tmp;
      selectors[i] = tmp;
    }
  }

  Group groups[6];
  for (u32 t = 0; t < n_groups; t++) {
    u32 curr; GET(curr, 5);
    u8 lens[258];
    for (i32 v = 0; v < alpha; v++) {
      for (;;) {
        if (curr < 1 || curr > 20) return BZT_DATA_ERROR;
        u32 b; GET(b, 1);
        if (!b) break;
        u32 d; GET(d, 1);
        curr += d ? -1 : 1;
      }
      lens[v] = (u8)curr;
    }
    if (!build_group(groups[t], lens, alpha)) return BZT_DATA_ERROR;
  }

  struct timespec dect0;
  if (getenv("BZ2TPU_DEBUG_TIMING")) clock_gettime(CLOCK_MONOTONIC, &dect0);
  dec_lap(0, &dect0);
  // MTF / RLE2 symbol loop
  u8 mtf[256];
  memcpy(mtf, used, n_used);
  memset(cftab, 0, 257 * sizeof(i32));
  i32 n = 0;
  i32 group_no = -1, group_pos = 0;
  Group* gr = nullptr;
  i64 run = 0;
  i32 run_bit = 0;
  i32 pending = -1;  // second symbol of a paired fast-table hit
  for (;;) {
    i32 sym;
    if (pending >= 0) {
      sym = pending;
      pending = -1;
    } else {
      if (group_pos == 0) {
        if (++group_no >= (i32)n_selectors) return BZT_DATA_ERROR;
        gr = &groups[selectors[group_no]];
        group_pos = 50;
      }
      u32 v = br.peek(Group::FAST_BITS);
      i32 f = gr->fast[v];
      i32 l1 = (f >> 1) & 15;
      if (f >= 0 && (f & 1) && group_pos >= 2 &&
          br.have(l1 + ((f >> 5) & 15))) {
        br.drop(l1 + ((f >> 5) & 15));
        sym = (f >> 9) & 511;
        pending = (f >> 18) & 511;
        group_pos -= 2;
        g_dec_pairs++;
      } else if (f >= 0 && br.have(l1)) {
        br.drop(l1);
        sym = (f >> 9) & 511;
        group_pos--;
        g_dec_singles++;
      } else {
        i32 l = gr->min_len;
        NEED(l);
        i32 code = br.peek(l);
        while (code > gr->limit[l]) {
          if (l >= gr->max_len) return BZT_DATA_ERROR;
          l++;
          NEED(l);
          code = br.peek(l);
        }
        br.drop(l);
        sym = gr->perm[code - gr->base[l]];
        group_pos--;
        g_dec_slow++;
      }
    }
    if (sym <= 1) {  // RUNA/RUNB
      if (run_bit >= 31) return BZT_DATA_ERROR;
      run += (i64)(sym + 1) << run_bit;
      run_bit++;
      continue;
    }
    if (run) {
      if (n + run > max_block) return BZT_DATA_ERROR;
      u8 c = mtf[0];
      cftab[c + 1] += (i32)run;
      memset(blk + n, c, run);
      n += (i32)run;
      run = 0; run_bit = 0;
    }
    if (sym == eob) break;
    i32 p = sym - 1;
    u8 c = mtf[p];
    if (p <= 16) {  // common case: short shift beats memmove's setup
      for (i32 q = p; q > 0; q--) mtf[q] = mtf[q - 1];
    } else {
      memmove(mtf + 1, mtf, p);
    }
    mtf[0] = c;
    if (n >= max_block) return BZT_DATA_ERROR;
    cftab[c + 1]++;
    blk[n++] = c;
  }
  if (n == 0 || (i32)orig_ptr >= n) return BZT_DATA_ERROR;
  dec_lap(1, &dect0);
  bs.n = n;
  bs.stored_crc = stored_crc;
  bs.randomised = randomised;
  bs.orig_ptr = orig_ptr;
  return BZT_OK;
}

// ---------------------------------------------------- device-decode export --
// Parse one block's header (start_bit at the 48-bit block magic) and
// light-scan the symbol stream (code-length chase only — no MTF, no
// output): everything the TPU decode path (bzip2_tpu/decoder.py) needs to
// run the heavy stages on device.  Wire semantics mirror the full decoder
// above (reference: decompress.c:281-473 header/tables; GET_MTF_VAL's
// length chase :103-228 without its value side).
//
// Outputs:
//   hdr_i32: [n_used, n_groups, n_selectors, orig_ptr, randomised, n_mtf,
//             n_groups_used]                                    (7 x i32)
//   hdr_i64: [sym_start_bit, end_bit]                           (2 x i64)
//   crc_out: stored block CRC
//   used_out[256] 0/1; selectors_out[18002] un-MTF'd group ids;
//   lens_out[6*258] code lengths; goff_out[18002] absolute bit offset of
//   each 50-symbol group's first code.
// Returns BZT_OK or a negative BZT_* error.
i32 bz2tpu_parse_block(const u8* data, i64 len, i64 start_bit, i32 max_block,
                       i32* hdr_i32, i64* hdr_i64, u32* crc_out, u8* used_out,
                       u8* selectors_out, u8* lens_out, i64* goff_out) {
  BitRd br{data + (start_bit >> 3), data + len};
  if (start_bit & 7) { br.fill(); br.drop((int)(start_bit & 7)); }
  u32 mag_hi, mag_lo;
  GET(mag_hi, 24); GET(mag_lo, 24);
  if (mag_hi != 0x314159u || mag_lo != 0x265359u) return BZT_DATA_ERROR_MAGIC;
  u32 stored_crc, w;
  GET(stored_crc, 16); GET(w, 16);
  stored_crc = (stored_crc << 16) | w;
  u32 randomised; GET(randomised, 1);
  if (randomised && !g_rnums_set) return BZT_DATA_ERROR;
  u32 orig_ptr; GET(orig_ptr, 24);
  if ((i32)orig_ptr > max_block) return BZT_DATA_ERROR;

  memset(used_out, 0, 256);
  u8 used[256];
  i32 n_used = 0;
  u32 gmask; GET(gmask, 16);
  for (i32 gi = 0; gi < 16; gi++) {
    if (gmask & (0x8000u >> gi)) {
      u32 bits; GET(bits, 16);
      for (i32 j = 0; j < 16; j++)
        if (bits & (0x8000u >> j)) {
          used[n_used++] = (u8)(gi * 16 + j);
          used_out[gi * 16 + j] = 1;
        }
    }
  }
  if (n_used == 0) return BZT_DATA_ERROR;
  i32 alpha = n_used + 2, eob = n_used + 1;

  u32 n_groups, n_selectors;
  GET(n_groups, 3); GET(n_selectors, 15);
  if (n_groups < 2 || n_groups > 6) return BZT_DATA_ERROR;
  if (n_selectors < 1 || n_selectors > 18002) return BZT_DATA_ERROR;

  for (u32 i = 0; i < n_selectors; i++) {
    i32 v = 0;
    for (;;) {
      u32 b; GET(b, 1);
      if (!b) break;
      if (++v >= (i32)n_groups) return BZT_DATA_ERROR;
    }
    selectors_out[i] = (u8)v;
  }
  {
    u8 pos[6] = {0, 1, 2, 3, 4, 5};
    for (u32 i = 0; i < n_selectors; i++) {
      i32 v = selectors_out[i];
      u8 tmp = pos[v];
      for (; v > 0; v--) pos[v] = pos[v - 1];
      pos[0] = tmp;
      selectors_out[i] = tmp;
    }
  }

  Group groups[6];
  memset(lens_out, 0, 6 * 258);
  for (u32 t = 0; t < n_groups; t++) {
    u32 curr; GET(curr, 5);
    u8* lens = lens_out + t * 258;
    for (i32 v = 0; v < alpha; v++) {
      for (;;) {
        if (curr < 1 || curr > 20) return BZT_DATA_ERROR;
        u32 b; GET(b, 1);
        if (!b) break;
        u32 d; GET(d, 1);
        curr += d ? -1 : 1;
      }
      lens[v] = (u8)curr;
    }
    if (!build_group(groups[t], lens, alpha)) return BZT_DATA_ERROR;
  }

  i64 sym_start = br.bit_pos(data);
  i64 n_mtf = 0;
  i64 n_out = 0;     // decoded block bytes (validation only)
  i64 run = 0;
  i32 run_bit = 0;
  i32 group_no = -1, group_pos = 0;
  Group* gr = nullptr;
  i32 pending = -1;  // second symbol of a paired fast-table hit
  for (;;) {
    i32 sym;
    if (pending >= 0) {
      sym = pending;
      pending = -1;
    } else {
      if (group_pos == 0) {
        if (++group_no >= (i32)n_selectors) return BZT_DATA_ERROR;
        goff_out[group_no] = br.bit_pos(data);
        gr = &groups[selectors_out[group_no]];
        group_pos = 50;
      }
      u32 v = br.peek(Group::FAST_BITS);
      i32 f = gr->fast[v];
      i32 l1 = (f >> 1) & 15;
      if (f >= 0 && (f & 1) && group_pos >= 2 &&
          br.have(l1 + ((f >> 5) & 15))) {
        br.drop(l1 + ((f >> 5) & 15));
        sym = (f >> 9) & 511;
        pending = (f >> 18) & 511;
        group_pos -= 2;
      } else if (f >= 0 && br.have(l1)) {
        br.drop(l1);
        sym = (f >> 9) & 511;
        group_pos--;
      } else {
        i32 l = gr->min_len;
        NEED(l);
        i32 code = br.peek(l);
        while (code > gr->limit[l]) {
          if (l >= gr->max_len) return BZT_DATA_ERROR;
          l++;
          NEED(l);
          code = br.peek(l);
        }
        br.drop(l);
        sym = gr->perm[code - gr->base[l]];
        group_pos--;
      }
    }
    n_mtf++;
    if (sym <= 1) {
      if (run_bit >= 31) return BZT_DATA_ERROR;
      run += (i64)(sym + 1) << run_bit;
      run_bit++;
      continue;
    }
    n_out += run;
    run = 0; run_bit = 0;
    if (sym == eob) break;
    n_out++;
    if (n_out > max_block) return BZT_DATA_ERROR;
  }
  if (n_out == 0 || n_out > max_block || (i64)orig_ptr >= n_out)
    return BZT_DATA_ERROR;

  hdr_i32[0] = n_used;
  hdr_i32[1] = (i32)n_groups;
  hdr_i32[2] = (i32)n_selectors;
  hdr_i32[3] = (i32)orig_ptr;
  hdr_i32[4] = (i32)randomised;
  hdr_i32[5] = (i32)n_mtf;
  hdr_i32[6] = group_no + 1;
  hdr_i64[0] = sym_start;
  hdr_i64[1] = br.bit_pos(data);
  *crc_out = stored_crc;
  return BZT_OK;
}

// inverse BWT: stable counting order with char + successor fused into one
// u32 per entry (one random access per output byte; the reference's
// composed-tt idea, decompress.c:767-790 / bzlib_private.h:442-444).
//
// The chain walk is split in two phases so independent blocks can hide
// each other's memory latency:
//   1. chase  — the pure pointer chase (tt[t>>8]), the latency-bound part.
//      Up to DEC_K blocks' chains are interleaved in ONE loop: each chain
//      is a serial dependency, but K chains give the core K outstanding
//      cache misses instead of one (memory-level parallelism), which is
//      worth ~3x on a 900k-entry table that misses LLC/L2.
//   2. expand — sequential RLE1 expansion (+ legacy derandomisation) of
//      the chased bytes into the output, then the vectorised block CRC.
// All bitstream reads happen in the symbol phase, so batching blocks does
// not perturb bit positions or error detection order observable from the
// API (errors still abort the whole call exactly as before).
// tt entries carry LOCAL successor indices ((succ << 8) | ch); each
// chain addresses its own stride of the shared table.  The stride is a
// compile-time constant per unrolled chain (i * DEC_MAXB folds into the
// instruction displacement), so per-chain state stays a single u32 and
// the chain count is not bounded by u32 index packing.
static void build_tt(const u8* blk, i32 n, i32* cftab, u32* tt_chain) {
  for (i32 i = 0; i < 256; i++) cftab[i + 1] += cftab[i];
  for (i32 i = 0; i < n; i++)
    tt_chain[cftab[blk[i]]++] = ((u32)i << 8) | blk[i];
}

enum {
#ifdef BZ2TPU_DEC_K
  DEC_K = BZ2TPU_DEC_K,
#else
  DEC_K = 28,        // interleaved chains (MLP width); 28 measured ~10%
                     // over 18 on 24 MB streams (wider tail batches);
                     // 24/32 were within noise of 28
#endif
  DEC_MAXB = 900000, // compile-time chain stride (= level-9 max block)
};

struct DecSlot {
  u8* blk = nullptr;  // max_block (MTF/RLE2-decoded block, BWT order)
  i32 cftab[257];
  BlockSym bs;
  i64 end_bit;        // bit just past this block (decode_some commit)
};

struct DecBatch {
  DecSlot sl[DEC_K];
  u32* tt_all = nullptr;    // DEC_K * DEC_MAXB; chain i at i * DEC_MAXB
  u8* chase_all = nullptr;  // chain i's chase bytes at i * DEC_MAXB
  int count = 0;
  i32 max_block = 0;

  bool ensure(int s) {
    if (!tt_all) {
      // one contiguous table (global successor indices address the whole
      // thing); all sizes are level-independent constants so the cached
      // instance below never reallocates.  Virtual until touched.
      tt_all = (u32*)malloc((i64)DEC_K * DEC_MAXB * 4);
      chase_all = (u8*)malloc((i64)DEC_K * DEC_MAXB);
      if (!tt_all || !chase_all) return false;
      advise_huge(tt_all, (i64)DEC_K * DEC_MAXB * 4);
      advise_huge(chase_all, (i64)DEC_K * DEC_MAXB);
    }
    DecSlot& d = sl[s];
    if (!d.blk) {
      d.blk = (u8*)malloc(DEC_MAXB);
      if (!d.blk) return false;
    }
    return true;
  }
  void release() {
    free(tt_all); free(chase_all);
    tt_all = nullptr; chase_all = nullptr;
    for (int s = 0; s < DEC_K; s++) { free(sl[s].blk); sl[s].blk = nullptr; }
    count = 0;
  }
};

// Persistent per-thread decode buffers: the first-touch fault cost of the
// ~90 MB working set on this VM class (and general heap churn between
// calls) would otherwise be repaid on every decompress call.  Thread-local
// because ctypes releases the GIL, so parallel decodes may overlap.
static thread_local DecBatch g_dec_batch;

void bz2tpu_free_decode_cache() { g_dec_batch.release(); }

// Interleaved chain chase over KN <= DEC_K blocks.  Each chain is a serial
// dependency, but KN chains give the core KN outstanding cache misses
// instead of one (memory-level parallelism) — the chase is L2/L3 latency
// bound, so this is worth ~4x.  Every chain runs nmax steps: the IBWT
// permutation is a single n-cycle, so a finished chain cycles back through
// valid indices and its surplus bytes are ignored by the expand phase.
// (A vpgatherdd formulation was measured SLOWER: the whole-register
// dependency convoys all lanes on the slowest load each step, while
// independent scalar chains drift freely.)
extern "C++" {  // template needs C++ linkage
template <int KN>
static void chase_kg(const u32* tt, u8* out_all, const u32* t0, i32 nmax) {
  u32 t[KN];
  for (int i = 0; i < KN; i++) t[i] = t0[i];
  for (i32 j = 0; j < nmax; j++) {
    for (int i = 0; i < KN; i++) {
      out_all[(i64)i * DEC_MAXB + j] = (u8)t[i];
      t[i] = tt[(i64)i * DEC_MAXB + (t[i] >> 8)];
    }
  }
}

// chase_kg<count> for 1 <= count <= KN.  The chain count must be exact: a
// wider instance would chase chains whose starts were never set.
template <int KN>
static void chase_k(int count, const u32* tt, u8* out_all, const u32* t0,
                    i32 nmax) {
  if constexpr (KN > 1) {
    if (count < KN) return chase_k<KN - 1>(count, tt, out_all, t0, nmax);
  }
  chase_kg<KN>(tt, out_all, t0, nmax);
}
}  // extern "C++"

static void chase_batch(const DecBatch& b, i32 nmax) {
  u32 t0[DEC_K];
  for (int i = 0; i < b.count; i++)
    t0[i] = b.tt_all[(i64)i * DEC_MAXB + b.sl[i].bs.orig_ptr];
  chase_k<DEC_K>(b.count, b.tt_all, b.chase_all, t0, nmax);
}

// RLE1-expand one chased block into ob; derandomise legacy streams inline
// (the mask applies to count bytes too, matching the fused walk semantics);
// verify the block CRC and fold it into the stream's combined CRC.
//
// Fast path: a 32-byte chunk with no 4 consecutive equal raw bytes cannot
// contain a run completion (runs are contiguous in the chase buffer), so
// it copies straight through.  Raw equality may false-positive across a
// count byte — that only drops to the scalar loop, never mis-decodes;
// the scalar loop's run state is recomputed from the trailing raw bytes
// clipped at the last consumed count byte, which is exact because chunks
// with mask==0 provably contain no count bytes and no runs >= 4.
static i32 expand_block(const DecBatch& b, int slot, OutBuf& ob,
                        u32* combined) {
  const u8* in = b.chase_all + (i64)slot * DEC_MAXB;
  const DecSlot& sl = b.sl[slot];
  const i32 n = sl.bs.n;
  if (!ob.grow((i64)n + 300)) return BZT_MEM_ERROR;
  i64 out_start = ob.len;
  RandState rs;
  const int rnd = (int)sl.bs.randomised;
  i64 last_cnt = -1;  // position of the last count byte consumed
  i32 i = 0;
  while (i < n) {
#ifdef __AVX2__
    if (!rnd && i >= 3) {
      while (i + 33 <= n) {  // +1: a completing run needs its count byte
        __m256i x0 = _mm256_loadu_si256((const __m256i*)(in + i));
        __m256i e1 = _mm256_cmpeq_epi8(
            x0, _mm256_loadu_si256((const __m256i*)(in + i - 1)));
        __m256i e2 = _mm256_cmpeq_epi8(
            x0, _mm256_loadu_si256((const __m256i*)(in + i - 2)));
        __m256i e3 = _mm256_cmpeq_epi8(
            x0, _mm256_loadu_si256((const __m256i*)(in + i - 3)));
        u32 m = (u32)_mm256_movemask_epi8(
            _mm256_and_si256(e1, _mm256_and_si256(e2, e3)));
        if (m) {
          // copy the literals ahead of the first run completion, then let
          // the scalar loop handle the event itself
          i32 p = (i32)__builtin_ctz(m);
          if (p > 3) {
            i32 safe = p - 3;
            if (ob.len + safe + 300 > ob.cap && !ob.grow(safe + 300))
              return BZT_MEM_ERROR;
            memcpy(ob.p + ob.len, in + i, safe);
            ob.len += safe;
            i += safe;
          }
          break;
        }
        if (ob.len + 332 > ob.cap && !ob.grow(332)) return BZT_MEM_ERROR;
        memcpy(ob.p + ob.len, in + i, 32);
        ob.len += 32;
        i += 32;
      }
      if (i >= n) break;
    }
#endif
    // scalar stretch: recompute run state from trailing raw bytes
    i32 run_ch = -1, run_len = 0;
    if (!rnd && i > 0) {
      u8 c0 = in[i - 1];
      while (run_len < 3 && (i64)(i - 1 - run_len) > last_cnt &&
             in[i - 1 - run_len] == c0)
        run_len++;
      if (run_len) run_ch = c0;
    }
    i32 lim = rnd ? n : (i + 8 < n ? i + 8 : n);
    while (i < lim) {
      if (ob.len + 300 > ob.cap && !ob.grow(300)) return BZT_MEM_ERROR;
      u8 ch = in[i++];
      if (rnd) ch ^= (u8)rs.next_mask();
      if ((i32)ch == run_ch) run_len++; else { run_ch = ch; run_len = 1; }
      ob.p[ob.len++] = ch;
      if (run_len == 4) {
        if (i >= n) return BZT_DATA_ERROR;
        u8 cnt = in[i];
        last_cnt = i;
        i++;
        if (rnd) cnt ^= (u8)rs.next_mask();
        if (cnt) {
          memset(ob.p + ob.len, ch, cnt);
          ob.len += cnt;
        }
        run_ch = -1;
        run_len = 0;
      }
    }
  }
  u32 crc = ~crc_update(0xffffffffu, ob.p + out_start, ob.len - out_start);
  if (crc != sl.bs.stored_crc) return BZT_DATA_ERROR;
  *combined = ((*combined << 1) | (*combined >> 31)) ^ crc;
  return BZT_OK;
}

// Chase + expand every pending block, in block order.  On success the
// batch is empty and *combined covers all flushed blocks.
static i32 flush_batch(DecBatch& b, OutBuf& ob, u32* combined) {
  if (b.count == 0) return BZT_OK;
  struct timespec dect0;
  if (getenv("BZ2TPU_DEBUG_TIMING")) clock_gettime(CLOCK_MONOTONIC, &dect0);
  i32 nmax = 0;
  for (int i = 0; i < b.count; i++) {
    build_tt(b.sl[i].blk, b.sl[i].bs.n, b.sl[i].cftab,
             b.tt_all + (i64)i * DEC_MAXB);
    if (b.sl[i].bs.n > nmax) nmax = b.sl[i].bs.n;
  }
  dec_lap(2, &dect0);
  chase_batch(b, nmax);
  dec_lap(3, &dect0);
  for (int i = 0; i < b.count; i++) {
    i32 rc = expand_block(b, i, ob, combined);
    if (rc != BZT_OK) return rc;
  }
  dec_lap(4, &dect0);
  b.count = 0;
  return BZT_OK;
}

#define GET2(v, k) do { if (!br.have(k)) { err = BZT_UNEXPECTED_EOF; goto done; } \
                        v = br.peek(k); br.drop(k); } while (0)

// Decode all streams in [data, data+len).  flags bit0: multi-stream.
// Returns BZT_OK and sets *out/*out_len (caller frees with bz2tpu_free);
// *consumed = bytes of input consumed (start of trailing garbage).
i32 bz2tpu_decompress(const u8* data, i64 len, int flags, u8** out,
                      i64* out_len, i64* consumed) {
  crc_init();
  BitRd br{data, data + len};
  OutBuf ob;
  i32 err = BZT_OK;
  int streams_done = 0;
  bool multi = (flags & 1) != 0;

  DecBatch& batch = g_dec_batch;
  batch.count = 0;

  while (true) {  // stream loop
    if (!br.have(8)) {
      if (streams_done == 0) err = BZT_DATA_ERROR_MAGIC;
      break;
    }
    if (!br.have(32)) {
      if (streams_done && multi) break;  // short trailing garbage
      err = BZT_DATA_ERROR_MAGIC;
      goto done;
    }
    u32 h;
    {  // stream header: peek, validate, then consume
      u32 hdr = br.peek(32);
      u32 b3 = hdr & 0xff;
      if ((hdr >> 8) != 0x425a68u || b3 < 0x31 || b3 > 0x39) {
        if (streams_done && multi) break;  // tolerated trailing garbage
        err = BZT_DATA_ERROR_MAGIC; goto done;
      }
      br.drop(32);
      h = b3 - 0x30;
    }
    {
      i32 max_block = 100000 * (i32)h;
      batch.max_block = max_block;
      u32 combined = 0;
      while (true) {  // block loop
        u32 mag_hi, mag_lo;
        if (!br.have(48)) { err = BZT_UNEXPECTED_EOF; goto done; }
        mag_hi = br.peek(24); br.drop(24);
        mag_lo = br.peek(24); br.drop(24);
        if (mag_hi == 0x177245 && mag_lo == 0x385090) {
          if ((err = flush_batch(batch, ob, &combined)) != BZT_OK) goto done;
          u32 hi16, lo16;
          GET2(hi16, 16); GET2(lo16, 16);
          u32 stored_comb = (hi16 << 16) | lo16;
          if (stored_comb != combined) { err = BZT_DATA_ERROR; goto done; }
          break;
        }
        if (mag_hi != 0x314159 || mag_lo != 0x265359) {
          err = BZT_DATA_ERROR; goto done;
        }
        if (!batch.ensure(batch.count)) { err = BZT_MEM_ERROR; goto done; }
        DecSlot& slot = batch.sl[batch.count];
        i32 rc = decode_block_symbols(br, max_block, slot.blk, slot.cftab,
                                      slot.bs);
        if (rc != BZT_OK) { err = rc; goto done; }
        if (++batch.count == DEC_K &&
            (err = flush_batch(batch, ob, &combined)) != BZT_OK)
          goto done;
      }
      streams_done++;
      br.drop(br.n & 7);  // streams are byte aligned
      if (!multi) break;
    }
  }

done:
  batch.count = 0;
  if (err == BZT_OK) {
    *out = ob.p;
    *out_len = ob.len;
    if (consumed) {
      i64 bitpos = (br.p - data) * 8 - br.n;
      *consumed = (bitpos + 7) / 8;
    }
    return BZT_OK;
  }
  free(ob.p);
  *out = nullptr;
  *out_len = 0;
  if (consumed) *consumed = 0;
  return err;
}

// Incremental decoder: decode as many COMPLETE blocks as are present.
//
//   level_in  == 0: expect a (byte-aligned) stream header at start_bit.
//   level_in 1..9: start_bit is a block boundary inside a stream with the
//                  given block-size level and running combined CRC.
//
// Outputs: decoded bytes (caller frees), next_bit (boundary reached),
// level/combined to resume with, and *status: 0 = need more input,
// 1 = stream end reached (next_bit just past the combined CRC, NOT yet
// byte-aligned; the caller aligns and may start the next stream).
i32 bz2tpu_decode_some(const u8* data, i64 len, i64 start_bit, i32 level_in,
                       u32 combined_in, u8** out, i64* out_len,
                       i64* next_bit, i32* level_out, u32* combined_out,
                       i32* status) {
  crc_init();
  OutBuf ob;
  i32 err = BZT_OK;
  i32 level = level_in;
  u32 combined = combined_in;
  *status = 0;

  BitRd br{data + (start_bit >> 3), data + len};
  if (start_bit & 7) { br.fill(); br.drop((int)(start_bit & 7)); }
  i64 done_bit = start_bit;  // last committed boundary

  DecBatch& batch = g_dec_batch;
  batch.count = 0;

  if (level == 0) {
    if (!br.have(32)) goto need_more;
    u32 hdr = br.peek(32);
    u32 b3 = hdr & 0xff;
    if ((hdr >> 8) != 0x425a68u || b3 < 0x31 || b3 > 0x39) {
      err = BZT_DATA_ERROR_MAGIC; goto done;
    }
    br.drop(32);
    level = (i32)(b3 - 0x30);
    done_bit += 32;
  }
  {
    batch.max_block = 100000 * level;

    while (true) {
      if (!br.have(48)) goto need_more;
      BitRd save = br;
      u32 mag_hi = br.peek(24); br.drop(24);
      u32 mag_lo = br.peek(24); br.drop(24);
      if (mag_hi == 0x177245 && mag_lo == 0x385090) {
        if (!br.have(32)) { br = save; goto need_more; }
        u32 hi16 = br.peek(16); br.drop(16);
        u32 lo16 = br.peek(16); br.drop(16);
        if ((err = flush_batch(batch, ob, &combined)) != BZT_OK) goto done;
        u32 stored = (hi16 << 16) | lo16;
        if (stored != combined) { err = BZT_DATA_ERROR; goto done; }
        done_bit = (br.p - data) * 8 - br.n;  // just past the 32-bit CRC
        *status = 1;
        break;
      }
      if (mag_hi != 0x314159 || mag_lo != 0x265359) {
        err = BZT_DATA_ERROR; goto done;
      }
      if (!batch.ensure(batch.count)) { err = BZT_MEM_ERROR; goto done; }
      DecSlot& slot = batch.sl[batch.count];
      i32 rc = decode_block_symbols(br, batch.max_block, slot.blk, slot.cftab,
                                    slot.bs);
      if (rc == BZT_UNEXPECTED_EOF) {
        br = save;
        goto need_more;
      }
      if (rc != BZT_OK) { err = rc; goto done; }
      slot.end_bit = (br.p - data) * 8 - br.n;
      if (++batch.count == DEC_K) {
        i64 last = batch.sl[DEC_K - 1].end_bit;
        if ((err = flush_batch(batch, ob, &combined)) != BZT_OK) goto done;
        done_bit = last;
      }
    }
  }

need_more:
  // blocks whose symbols parsed completely are decodable: flush and commit
  if (err == BZT_OK && batch.count > 0) {
    i64 last = batch.sl[batch.count - 1].end_bit;
    err = flush_batch(batch, ob, &combined);
    if (err == BZT_OK) done_bit = last;
  }
done:
  batch.count = 0;
  if (err == BZT_OK) {
    *out = ob.p;
    *out_len = ob.len;
    *next_bit = done_bit;
    *level_out = level;
    *combined_out = combined;
    return BZT_OK;
  }
  free(ob.p);
  *out = nullptr; *out_len = 0;
  *next_bit = start_bit;
  *level_out = level_in;
  *combined_out = combined_in;
  return err;
}

void bz2tpu_free(u8* p) { free(p); }

// ------------------------------------------------------------------ RLE1 --
// Byte-level run-length pre-pass + block split (reference
// copy_input_until_stop, bzlib.c:212-315; split semantics documented and
// verified in bzip2_tpu_torch/rle1.py).  Segments = maximal runs chopped at
// 255; a segment of length L emits min(L,4) literals plus (L-4) for L >= 4;
// segments flush whole, and a block closes after the segment that brings
// it to >= nmax output bytes unless that segment is the stream's last.
//
// Wide path.  Text and binary data hold almost no runs of 4 or more, and
// there RLE1 copies its input.  At a position i with RLE1_W + 3 bytes of
// input after it and RLE1_W bytes of room in the open block, and no run of
// 4 at i itself, one vector step compares the RLE1_W bytes at i with
// those at i+1, i+2 and i+3.  Every run that starts before the first run
// of four equal bytes in the window is shorter than 4 and copied unchanged,
// so the step stores the window and moves i to that run's start, or, if
// the window has none, past the window: a run shorter than 4 that crosses
// its end is literal however it is cut.
// A run of 4 or more goes to the per-run loop, which passes it before the
// next step: run-heavy input pays one 4-byte compare a run.  No block
// closes inside a step (the room guard), so blocks close where the per-run
// loop alone closes them.
#if defined(__AVX2__)
#define RLE1_W 32
// Stores the 32 bytes at p to dst.  Returns bit k set iff p[k..k+3] are
// equal.
static inline u32 rle1_window(const u8* p, u8* dst) {
  __m256i x = _mm256_loadu_si256((const __m256i*)p);
  __m256i e1 = _mm256_cmpeq_epi8(
      x, _mm256_loadu_si256((const __m256i*)(p + 1)));
  __m256i e2 = _mm256_cmpeq_epi8(
      x, _mm256_loadu_si256((const __m256i*)(p + 2)));
  __m256i e3 = _mm256_cmpeq_epi8(
      x, _mm256_loadu_si256((const __m256i*)(p + 3)));
  _mm256_storeu_si256((__m256i*)dst, x);
  return (u32)_mm256_movemask_epi8(
      _mm256_and_si256(e1, _mm256_and_si256(e2, e3)));
}
#elif defined(__SSE2__)
#define RLE1_W 16
static inline u32 rle1_window(const u8* p, u8* dst) {
  __m128i x = _mm_loadu_si128((const __m128i*)p);
  __m128i e1 = _mm_cmpeq_epi8(x, _mm_loadu_si128((const __m128i*)(p + 1)));
  __m128i e2 = _mm_cmpeq_epi8(x, _mm_loadu_si128((const __m128i*)(p + 2)));
  __m128i e3 = _mm_cmpeq_epi8(x, _mm_loadu_si128((const __m128i*)(p + 3)));
  _mm_storeu_si128((__m128i*)dst, x);
  return (u32)_mm_movemask_epi8(_mm_and_si128(e1, _mm_and_si128(e2, e3)));
}
#endif

// out:        caller buffer, >= len + len/4 + 8 bytes (a wide step stores
//             RLE1_W bytes at the output position, all below that bound)
// block_off:  (max_blocks) output offset of each block
// block_len:  (max_blocks) RLE1-encoded length of each block
// block_crc:  (max_blocks) finalized CRC-32 of the covered raw bytes
// in_use:     (max_blocks * 256) 0/1 flags
// raw_end:    (max_blocks) exclusive raw-input end of each block
// wide_bytes: the input bytes the wide path copied
// Returns the number of blocks, or -1 if max_blocks would be exceeded.
i64 bz2tpu_rle1_split(const u8* data, i64 len, i32 nmax, u8* out,
                      i64* block_off, i32* block_len, u32* block_crc,
                      u8* in_use, i64* raw_end, i64 max_blocks,
                      i64* wide_bytes) {
  crc_init();
  i64 n_blocks = 0;
  i64 opos = 0;
  i64 blk_out0 = 0, blk_raw0 = 0;
  u8* use = in_use;
  bool open = false;
  i64 i = 0, wide = 0;
  while (i < len) {
    if (!open) {
      if (n_blocks >= max_blocks) return -1;
      memset(use, 0, 256);
      blk_out0 = opos;
      blk_raw0 = i;
      open = true;
    }
    u8 c = data[i];
    i64 j = i + 1;
#ifdef RLE1_W
    if (i + RLE1_W + 3 < len && opos - blk_out0 + RLE1_W < nmax) {
      u32 head;
      memcpy(&head, data + i, 4);
      if (head != c * 0x01010101u) {
        u32 quad = rle1_window(data + i, out + opos);
        // quad's lowest bit is a run start (>= 1: no run of 4 at i)
        i64 step = quad ? __builtin_ctz(quad) : RLE1_W;
        for (i64 k = 0; k < step; k++) use[data[i + k]] = 1;
        i += step;
        opos += step;
        wide += step;
        continue;
      }
      j = i + 4;  // the run at i is 4 long at least
    }
#endif
    i64 stop = i + 255 < len ? i + 255 : len;
    while (j < stop && data[j] == c) j++;
    i64 L = j - i;
    i64 lit = L < 4 ? L : 4;
    for (i64 t = 0; t < lit; t++) out[opos++] = c;
    use[c] = 1;
    if (L >= 4) {
      out[opos++] = (u8)(L - 4);
      use[(u8)(L - 4)] = 1;
    }
    i = j;
    if (opos - blk_out0 >= nmax && i < len) {
      block_off[n_blocks] = blk_out0;
      block_len[n_blocks] = (i32)(opos - blk_out0);
      block_crc[n_blocks] = ~crc_update(0xffffffffu, data + blk_raw0,
                                        i - blk_raw0);
      raw_end[n_blocks] = i;
      n_blocks++;
      use += 256;
      open = false;
    }
  }
  if (open) {
    block_off[n_blocks] = blk_out0;
    block_len[n_blocks] = (i32)(opos - blk_out0);
    block_crc[n_blocks] = ~crc_update(0xffffffffu, data + blk_raw0,
                                      len - blk_raw0);
    raw_end[n_blocks] = len;
    n_blocks++;
  }
  *wide_bytes = wide;
  return n_blocks;
}

}  // extern "C" (templates need C++ linkage)

// ----------------------------------------------------------------- SA-IS --
// Suffix array by induced sorting (the published Nong/Zhang/Chan SA-IS
// algorithm, implemented from its description).  s: values in [1, K) with
// s[n-1] == 0 the unique smallest sentinel.  Writes SA[0..n).
// Templated on the text type so the byte level runs on u16 (cache).
template <typename C>
static void sais_t(const C* s, i32* SA, i32 n, i32 K) {
  if (n == 1) { SA[0] = 0; return; }
  std::vector<u8> t(n);
  t[n - 1] = 1;
  for (i32 i = n - 2; i >= 0; i--)
    t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;
  auto is_lms = [&](i32 i) { return i > 0 && t[i] && !t[i - 1]; };
  // fused (value, type) so the induce loops do one random load per entry
  std::vector<C> c(n);
  for (i32 i = 0; i < n; i++) c[i] = (C)(((u32)s[i] << 1) | t[i]);
  std::vector<i32> cnt(K, 0), bkt(K);
  for (i32 i = 0; i < n; i++) cnt[s[i]]++;
  auto bucket_start = [&]() {
    i32 sum = 0;
    for (i32 c = 0; c < K; c++) { bkt[c] = sum; sum += cnt[c]; }
  };
  auto bucket_end = [&]() {
    i32 sum = 0;
    for (i32 c = 0; c < K; c++) { sum += cnt[c]; bkt[c] = sum; }
  };
  auto induce = [&]() {
    bucket_start();
    for (i32 i = 0; i < n; i++) {
      if (i + 48 < n) {
        i32 a = SA[i + 48];
        if (a > 0) __builtin_prefetch(&c[a - 1]);
      }
      if (SA[i] > 0) {
        i32 j = SA[i] - 1;
        C cj = c[j];
        if (!(cj & 1)) SA[bkt[cj >> 1]++] = j;
      }
    }
    bucket_end();
    for (i32 i = n - 1; i >= 0; i--) {
      if (i - 48 >= 0) {
        i32 a = SA[i - 48];
        if (a > 0) __builtin_prefetch(&c[a - 1]);
      }
      if (SA[i] > 0) {
        i32 j = SA[i] - 1;
        C cj = c[j];
        if (cj & 1) SA[--bkt[cj >> 1]] = j;
      }
    }
  };

  // stage 1: approximate LMS order, induce, then name LMS substrings
  std::fill(SA, SA + n, -1);
  bucket_end();
  for (i32 i = 1; i < n; i++)
    if (is_lms(i)) SA[--bkt[s[i]]] = i;
  induce();

  i32 n1 = 0;
  for (i32 i = 0; i < n; i++)
    if (is_lms(SA[i])) SA[n1++] = SA[i];
  std::fill(SA + n1, SA + n, -1);
  i32 name = 0, prev = -1;
  for (i32 i = 0; i < n1; i++) {
    i32 pos = SA[i];
    bool diff = false;
    for (i32 d = 0; d < n; d++) {
      if (prev < 0 || s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
        diff = true;
        break;
      }
      if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
    }
    if (diff) { name++; prev = pos; }
    SA[n1 + pos / 2] = name - 1;
  }
  for (i32 i = n - 1, j = n - 1; i >= n1; i--)
    if (SA[i] >= 0) SA[j--] = SA[i];

  // stage 2: order LMS suffixes (recurse while names collide)
  i32* SA1 = SA;
  i32* s1 = SA + n - n1;
  if (name < n1) {
    sais_t<i32>(s1, SA1, n1, name);
  } else {
    for (i32 i = 0; i < n1; i++) SA1[s1[i]] = i;
  }
  {
    i32 k = 0;
    for (i32 i = 1; i < n; i++)
      if (is_lms(i)) s1[k++] = i;
    for (i32 i = 0; i < n1; i++) SA1[i] = s1[SA1[i]];
  }

  // stage 3: final induced sort from the exact LMS order
  std::fill(SA + n1, SA + n, -1);
  bucket_end();
  for (i32 i = n1 - 1; i >= 0; i--) {
    i32 j = SA[i];
    SA[i] = -1;
    SA[--bkt[s[j]]] = j;
  }
  induce();
}

// ---------------------------------------------------------- cyclic SA-IS --
// Rotation sort of a PRIMITIVE string (no two rotations equal): SA-IS with
// cyclic comparisons end-to-end — type classification, LMS substrings, the
// induced sorts and the recursion all wrap mod n.  Replaces the
// doubled-string reduction (half the text, half the SA, better locality).
// The cyclic-specific facts that keep the published induce proof intact:
//   * every occurrence of the minimal character is S-type (propagating
//     t[i]=t[i+1] through equal chars ends at a strictly larger successor),
//     so the minimal bucket has no L region and the minimal rotation is
//     LMS — the left-to-right L-scan is fully seeded by LMS placements;
//   * a primitive string of n >= 2 has both L and S positions, so at least
//     one LMS exists and the type recurrence has an anchor position with
//     s[i] != s[i+1 mod n];
//   * the reduced (LMS-name) string of a primitive string is itself
//     primitive (a cyclic period in names would lift to one in the text),
//     so the recursion keeps the invariant.
// Callers guarantee primitivity by reducing to the KMP root first.
// BZ2TPU_SAIS_TIMING=1 prints per-call stage laps (u8 top level only).
static bool g_sais_dbg_init = false, g_sais_dbg = false;
struct SaisLap {
  struct timespec t0;
  bool on;
  explicit SaisLap(bool enable) : on(enable) {
    if (on) clock_gettime(CLOCK_MONOTONIC, &t0);
  }
  void lap(const char* what, i64 n) {
    if (!on) return;
    struct timespec t1;
    clock_gettime(CLOCK_MONOTONIC, &t1);
    fprintf(stderr, "[sais] %-8s %.4f n=%lld\n", what,
            (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec),
            (long long)n);
    t0 = t1;
  }
};
template <typename C>
static void csais_t(const C* s, i32* SA, i32 n, i32 K) {
  if (n == 1) { SA[0] = 0; return; }
  if (!g_sais_dbg_init) {
    g_sais_dbg = getenv("BZ2TPU_SAIS_TIMING") != nullptr;
    g_sais_dbg_init = true;
  }
  SaisLap lap_(g_sais_dbg && sizeof(C) == 1);
  std::vector<u8> t(n);
  i32 anchor = -1;
  for (i32 i = 0; i < n; i++) {
    i32 i1 = (i + 1 == n) ? 0 : i + 1;
    if (s[i] != s[i1]) { anchor = i; break; }
  }
  if (anchor < 0) {  // defensive: all-equal input (callers exclude it)
    for (i32 i = 0; i < n; i++) SA[i] = i;
    return;
  }
  {
    i32 a1 = (anchor + 1 == n) ? 0 : anchor + 1;
    t[anchor] = s[anchor] < s[a1];
    for (i32 step = 1; step < n; step++) {
      i32 i = anchor - step;
      if (i < 0) i += n;
      i32 i1 = (i + 1 == n) ? 0 : i + 1;
      t[i] = (s[i] != s[i1]) ? (s[i] < s[i1]) : t[i1];
    }
  }
  auto is_lms = [&](i32 i) { return t[i] && !t[i ? i - 1 : n - 1]; };
  // fused (value, type) per position: the induce loops do one random load
  // per entry and the naming loop compares (char, type) in one shot
  using F = typename std::conditional<sizeof(C) == 1, u16, u32>::type;
  std::vector<F> c(n);
  for (i32 i = 0; i < n; i++) c[i] = (F)(((u32)s[i] << 1) | t[i]);
  std::vector<i32> cnt(K, 0), bkt(K);
  for (i32 i = 0; i < n; i++) cnt[s[i]]++;
  auto bucket_start = [&]() {
    i32 sum = 0;
    for (i32 k = 0; k < K; k++) { bkt[k] = sum; sum += cnt[k]; }
  };
  auto bucket_end = [&]() {
    i32 sum = 0;
    for (i32 k = 0; k < K; k++) { sum += cnt[k]; bkt[k] = sum; }
  };
  // (A fully branchless induce was measured slower here: the type/empty
  // branches predict well on real text, and the unconditional bucket
  // read-modify-write costs more than the rare mispredicts.)
  auto induce = [&]() {
    bucket_start();
    for (i32 i = 0; i < n; i++) {
      if (i + 24 < n) {
        i32 a = SA[i + 24];
        if (a >= 0) __builtin_prefetch(&c[a ? a - 1 : n - 1]);
      }
      i32 j = SA[i];
      if (j >= 0) {
        i32 jp = j ? j - 1 : n - 1;
        F cj = c[jp];
        if (!(cj & 1)) SA[bkt[cj >> 1]++] = jp;
      }
    }
    bucket_end();
    for (i32 i = n - 1; i >= 0; i--) {
      if (i - 24 >= 0) {
        i32 a = SA[i - 24];
        if (a >= 0) __builtin_prefetch(&c[a ? a - 1 : n - 1]);
      }
      i32 j = SA[i];
      if (j >= 0) {
        i32 jp = j ? j - 1 : n - 1;
        F cj = c[jp];
        if (cj & 1) SA[--bkt[cj >> 1]] = jp;
      }
    }
  };

  // Packed induce (u8 top level, n < 2^20): each occupied SA slot carries
  // (t[x] << 29) | (x << 9) | c[x-1], so the bucket-counter update — the
  // serial dependence chain of induced sorting — no longer waits on the
  // random c[x-1] load; the only random read (c[x-2], for the value being
  // stored) is off the critical path and overlaps across iterations.
  const bool packed = (sizeof(C) == 1) && n < (1 << 20);
  auto pk = [&](i32 x, u32 cx, u32 cx1) -> i32 {
    return (i32)(((cx & 1u) << 29) | ((u32)x << 9) | cx1);
  };
  auto induce_p = [&]() {
    bucket_start();
    for (i32 i = 0; i < n; i++) {
      if (i + 24 < n) {
        i32 a = SA[i + 24];
        if (a >= 0) {
          i32 x = (a >> 9) & 0xFFFFF;
          __builtin_prefetch(&c[x >= 2 ? x - 2 : 0]);
        }
      }
      i32 v = SA[i];
      if (v >= 0) {
        u32 cx1 = (u32)v & 511u;
        if (!(cx1 & 1)) {
          i32 x = (v >> 9) & 0xFFFFF;
          i32 xp = x ? x - 1 : n - 1;
          i32 xpp = xp ? xp - 1 : n - 1;
          SA[bkt[cx1 >> 1]++] = pk(xp, cx1, (u32)c[xpp]);
        }
      }
    }
    bucket_end();
    for (i32 i = n - 1; i >= 0; i--) {
      if (i - 24 >= 0) {
        i32 a = SA[i - 24];
        if (a >= 0) {
          i32 x = (a >> 9) & 0xFFFFF;
          __builtin_prefetch(&c[x >= 2 ? x - 2 : 0]);
        }
      }
      i32 v = SA[i];
      if (v >= 0) {
        u32 cx1 = (u32)v & 511u;
        if (cx1 & 1) {
          i32 x = (v >> 9) & 0xFFFFF;
          i32 xp = x ? x - 1 : n - 1;
          i32 xpp = xp ? xp - 1 : n - 1;
          SA[--bkt[cx1 >> 1]] = pk(xp, cx1, (u32)c[xpp]);
        }
      }
    }
  };

  lap_.lap("prep", n);
  // stage 1: approximate LMS order, induce, then name cyclic LMS substrings
  std::fill(SA, SA + n, -1);
  bucket_end();
  i32 n1 = 0;
  if (packed) {
    for (i32 i = 0; i < n; i++)
      if (is_lms(i)) {
        SA[--bkt[s[i]]] = pk(i, (u32)c[i], (u32)c[i ? i - 1 : n - 1]);
        n1++;
      }
    induce_p();
  } else {
    for (i32 i = 0; i < n; i++)
      if (is_lms(i)) { SA[--bkt[s[i]]] = i; n1++; }
    induce();
  }
  lap_.lap("induce1", n);

  {
    i32 k = 0;
    if (packed) {
      // is_lms(x) == t[x] && !t[x-1]; both ride in the packed slot
      for (i32 i = 0; i < n; i++) {
        i32 v = SA[i];
        if (((v >> 29) & 1) && !(v & 1)) SA[k++] = (v >> 9) & 0xFFFFF;
      }
    } else {
      for (i32 i = 0; i < n; i++)
        if (is_lms(SA[i])) SA[k++] = SA[i];
    }
  }
  std::fill(SA + n1, SA + n, -1);
  // Cyclic LMS-substring lengths (distance to the next LMS), keyed pos/2
  // like the name slots: two substrings are equal iff their lengths match
  // and the fused (char,type) span matches inclusive of the terminal LMS —
  // which lets equal-length candidates resolve via one memcmp instead of
  // the entry-at-a-time walk.
  std::vector<i32> lms_len(n / 2 + 1);
  {
    i32 first = -1, prevp = -1;
    for (i32 i = 0; i < n; i++)
      if (is_lms(i)) {
        if (prevp >= 0) lms_len[prevp / 2] = i - prevp;
        else first = i;
        prevp = i;
      }
    if (prevp >= 0) lms_len[prevp / 2] = n - prevp + first;
  }
  i32 name = 0, prev = -1;
  for (i32 i = 0; i < n1; i++) {
    if (i + 8 < n1) {  // SA[i+8] is known: pull its three random lines in
      i32 q = SA[i + 8];
      __builtin_prefetch(&c[q]);
      __builtin_prefetch(&lms_len[q / 2]);
      __builtin_prefetch(&SA[n1 + q / 2], 1);
    }
    i32 pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      i32 la = lms_len[pos / 2];
      if (la != lms_len[prev / 2]) {
        diff = true;
      } else if (pos + la < n && prev + la < n) {
        diff = memcmp(&c[pos], &c[prev], (size_t)(la + 1) * sizeof(F)) != 0;
      } else {  // a span wraps the cyclic boundary (at most one per string)
        i32 a = pos, b = prev;
        for (i32 d = 0; d <= la; d++) {
          if (c[a] != c[b]) { diff = true; break; }
          a = (a + 1 == n) ? 0 : a + 1;
          b = (b + 1 == n) ? 0 : b + 1;
        }
      }
    }
    if (diff) { name++; prev = pos; }
    SA[n1 + pos / 2] = name - 1;  // cyclic LMS gaps are >= 2, so pos/2 is 1:1
  }
  for (i32 i = n - 1, j = n - 1; i >= n1; i--)
    if (SA[i] >= 0) SA[j--] = SA[i];
  lap_.lap("name", n1);

  // stage 2: exact LMS rotation order (recurse while names collide)
  i32* SA1 = SA;
  i32* s1 = SA + n - n1;
  if (name < n1) {
    csais_t<i32>(s1, SA1, n1, name);
  } else {
    for (i32 i = 0; i < n1; i++) SA1[s1[i]] = i;
  }
  lap_.lap("recurse", n1);
  {
    i32 k = 0;
    for (i32 i = 0; i < n; i++)
      if (is_lms(i)) s1[k++] = i;
    for (i32 i = 0; i < n1; i++) {
      if (i + 16 < n1) __builtin_prefetch(&s1[SA1[i + 16]]);
      SA1[i] = s1[SA1[i]];
    }
  }

  // stage 3: final induced sort from the exact LMS order
  std::fill(SA + n1, SA + n, -1);
  bucket_end();
  if (packed) {
    for (i32 i = n1 - 1; i >= 0; i--) {
      if (i - 8 >= 0) {
        i32 q = SA[i - 8];
        __builtin_prefetch(&c[q ? q - 1 : n - 1]);  // line also holds c[q]
      }
      i32 j = SA[i];
      SA[i] = -1;
      u32 cj = (u32)c[j];  // s[j] == cj >> 1: one random line, not two
      SA[--bkt[cj >> 1]] = pk(j, cj, (u32)c[j ? j - 1 : n - 1]);
    }
    induce_p();
    for (i32 i = 0; i < n; i++) SA[i] = (SA[i] >> 9) & 0xFFFFF;
  } else {
    for (i32 i = n1 - 1; i >= 0; i--) {
      i32 j = SA[i];
      SA[i] = -1;
      SA[--bkt[s[j]]] = j;
    }
    induce();
  }
  lap_.lap("induce2", n);
}

// --------------------------------------- rotation sort, bucket + rank path --
// Cache-partitioned rotation sorter for the primitive root:
//   1. a 2-byte bucket pass,
//   2. inside each pending small bucket, iterative rank-key refinement:
//      gather the partial rank ISA[i + depth] for every member (one
//      software-prefetched streaming gather — the random reads overlap
//      ~10-deep instead of serialising behind compare branches), pack
//      (rank << 32 | idx) into u64 and sort THAT in cache, then recurse
//      on equal-rank runs 2 bytes deeper,
//   3. copy-induction of every [x, c] small bucket from each finished
//      big bucket c (big buckets processed smallest-first, with
//      chasing-cursor scans so the self-referential [c, c] bucket fills
//      itself from both ends),
//   4. ISA finalisation as buckets complete: a finished rotation's rank
//      becomes its exact SA slot, so later (larger) buckets resolve deep
//      ties in a single rank compare instead of byte-at-a-time scans.
// The induced-copy idea and the partial-rank tiebreak are the classic
// BWT-sorter devices (the reference family: blocksort.c quadrants /
// divsufsort trsort); the cyclic setting here works on a doubled buffer
// of the KMP-primitive root, where rotations are distinct before depth
// p.  ISA invariant: ISA[i] is the start of rotation i's current
// refinement run — initially the 2-byte bucket start, refined on every
// split (written back), and the exact SA slot once the run is a
// singleton / the bucket finishes.  Runs are disjoint and only ever
// split, so every snapshot is a consistent partial order and equal
// values imply the same unfinished run (>= 2 more equal bytes).
// Returns false when the work budget blows up (deep-repeat adversaries)
// — the caller then falls back to the cyclic SA-IS, which also serves
// as the differential oracle for this path.
namespace mkqs {

struct Seg { i32 off, n, depth; };  // offsets into the bucket

struct Ctx {
  const u8* d;    // doubled root, length 2p (+pad)
  u32* isa;       // partial ranks, length p (index mod p); refined on split
  i32 p;
  i64 budget;     // remaining work; <0 => bail
  // per-block scratch, TLS-resolved once by the caller (a dlopen'd .so
  // pays a __tls_get_addr call per thread_local access otherwise)
  std::vector<Seg>* stack;
  std::vector<u64>* kv;
  std::vector<u64>* kv2;  // radix double-buffer
};

// instrumentation (BZ2TPU_MKQS_TIMING): tsc + element tallies per stage
static bool g_prof = false;
static u64 g_tsc_gather = 0, g_tsc_sort = 0;
static u64 g_n_gather = 0, g_n_segs = 0;
static i32 g_max_depth = 0;
// size-class attribution: whole-segment tsc by segment size
// classes: 0:=2  1:<=8  2:<=40  3:<=256  4:<=2048  5:>2048
static u64 g_cls_tsc[6] = {}, g_cls_n[6] = {}, g_cls_elems[6] = {};
static inline i32 size_class(i32 n) {
  return n <= 2 ? 0 : n <= 8 ? 1 : n <= 40 ? 2
       : n <= 256 ? 3 : n <= 2048 ? 4 : 5;
}

static bool sort_bucket(Ctx& c, i32* A, i32 n, i32 depth, i32 gbase) {
  auto& stack = *c.stack;
  auto& kvv = *c.kv;
  auto& kvv2 = *c.kv2;
  stack.clear();
  stack.push_back({0, n, depth});
  if ((i32)kvv.size() < n) { kvv.resize(n); kvv2.resize(n); }
  u64* kv = kvv.data();
  u64* kv2 = kvv2.data();
  u32* const isa = c.isa;
  const i32 p = c.p;
  while (!stack.empty()) {
    Seg sg = stack.back();
    stack.pop_back();
    i32* a = A + sg.off;
    if (sg.depth >= p) continue;  // distinct rotations: unreachable guard
    u64 tseg = g_prof ? __rdtsc() : 0;
    if (sg.n == 2) {
      // pair fast path: the two rotations agree to sg.depth, and on the
      // doubled buffer rotation i is d[i..i+p), so ONE sequential scan
      // settles them (primitive root => never equal).  This turns deep
      // tandem-repeat ties (LCPs of 100k+ from duplicated chunks) from
      // tens of thousands of 2-byte refinement passes into a stream read.
      // 8-byte chunks; the scan length is charged to the budget so
      // repeat-saturated adversaries still bail promptly.
      const u8* q0 = c.d + a[0] + sg.depth;
      const u8* q1 = c.d + a[1] + sg.depth;
      i32 rem = p - sg.depth;
      i32 off = 0;
      i32 r = 0;
      while (!r && rem - off >= 8) {
        // one 32-byte stripe of direct comparison...
        i32 stripe = off + 32 <= rem ? off + 32 : (rem & ~7);
        for (; off < stripe; off += 8) {
          u64 v0, v1;
          memcpy(&v0, q0 + off, 8);
          memcpy(&v1, q1 + off, 8);
          if (v0 != v1) {
            r = __builtin_bswap64(v0) < __builtin_bswap64(v1) ? -1 : 1;
            break;
          }
        }
        if (r) break;
        // ...then a rank probe at the now-VERIFIED equal depth: agreement
        // to sg.depth+off makes isa[(a+sg.depth+off) mod p] a valid
        // suffix-order comparison, and writeback-refined neighbor ranks
        // usually settle even 100k-deep ties within a few stripes
        i32 w0 = a[0] + sg.depth + off;
        if (w0 >= p) w0 -= p;
        i32 w1 = a[1] + sg.depth + off;
        if (w1 >= p) w1 -= p;
        u32 r0 = isa[w0], r1 = isa[w1];
        if (r0 != r1) { r = r0 < r1 ? -1 : 1; break; }
      }
      if (!r)
        for (; off < rem; off++)
          if (q0[off] != q1[off]) { r = q0[off] < q1[off] ? -1 : 1; break; }
      if (r > 0) std::swap(a[0], a[1]);
      u32 s0 = (u32)(gbase + sg.off);
      isa[a[0]] = s0;
      isa[a[1]] = s0 + 1;
      c.budget -= 4 + (off >> 4);
      if (c.budget < 0) return false;
      if (g_prof) {
        g_cls_tsc[0] += __rdtsc() - tseg; g_cls_n[0]++; g_cls_elems[0] += 2;
      }
      continue;
    }
    // depth-weighted charge: visits at depth d cost 1 + d/4096 — deep
    // refinement is the signature of repeat-saturated blocks (corpus
    // blocks stay under depth ~850, < +21%), so hopeless inputs reach
    // the bail several times sooner while real text is unaffected
    c.budget -= sg.n + (((i64)sg.n * sg.depth) >> 12);
    if (c.budget < 0) return false;
    if (g_prof && sg.depth > g_max_depth) g_max_depth = sg.depth;
    u64 t0 = g_prof ? __rdtsc() : 0;
    // double-rank key: isa[w] and isa[w+2] are 8 bytes apart, almost
    // always the same cache line, so one gather orders by FOUR bytes
    // (ranks summarize 2 bytes each) — refinement levels halve for the
    // same memory traffic.  p < 2^20 (block cap 900000), so
    // (r1:20 | r2:20 | idx:20) packs into 60 bits, lexicographic u64.
    const bool two = sg.depth + 2 < p;
    const i32 step = two ? 4 : 2;
    for (i32 i = 0; i < sg.n; i++) {
      if (i + 12 < sg.n) {
        i32 w = a[i + 12] + sg.depth;
        if (w >= p) w -= p;
        __builtin_prefetch(isa + w, 0, 0);
      }
      i32 w = a[i] + sg.depth;
      if (w >= p) w -= p;
      i32 w2 = w + 2;
      if (w2 >= p) w2 -= p;
      u64 r2 = two ? isa[w2] : 0;
      kv[i] = ((u64)isa[w] << 40) | (r2 << 20) | (u32)a[i];
    }
    u64 t1 = g_prof ? __rdtsc() : 0;
    if (sg.n <= 40) {
      for (i32 i = 1; i < sg.n; i++) {  // inline: no dispatch overhead
        u64 v = kv[i];
        i32 j = i;
        while (j > 0 && kv[j - 1] > v) { kv[j] = kv[j - 1]; j--; }
        kv[j] = v;
      }
    } else if (sg.n <= 600) {
      // mid-size: one MSD-256 scatter on r1's top 8 bits (52..59), then
      // insertion sort — after the scatter the array is grouped by
      // digit, so insertions never cross group boundaries and the
      // expected within-group pair count is tiny.  A skewed digit
      // histogram (concentrated ranks on repetitive text) would make the
      // insertion quadratic, so those segments bail to introsort.
      // (600..2048 measured FASTER on the 2x10-bit LSD path below.)
      u32 cnt[256];
      memset(cnt, 0, sizeof cnt);
      bool skew = false;
      for (i32 i = 0; i < sg.n; i++)
        if (++cnt[(kv[i] >> 52) & 255] > 48) { skew = true; break; }
      if (skew) {
        std::sort(kv, kv + sg.n);
      } else {
        u32 sum = 0;
        for (i32 k = 0; k < 256; k++) { u32 t = cnt[k]; cnt[k] = sum; sum += t; }
        for (i32 i = 0; i < sg.n; i++) kv2[cnt[(kv[i] >> 52) & 255]++] = kv[i];
        std::swap(kv, kv2);
        for (i32 i = 1; i < sg.n; i++) {
          u64 v = kv[i];
          i32 j = i;
          while (j > 0 && kv[j - 1] > v) { kv[j] = kv[j - 1]; j--; }
          kv[j] = v;
        }
      }
    } else {
      // large segments: two 10-bit LSD passes on r1 (bits 40..59), then
      // introsort each equal-r1 run on the residual (r2, idx) low bits —
      // equal-r1 runs are short on real data, so this beats paying four
      // full radix passes for the r2 half of the key
      u64* kb = kv2;
      u32 cnt[1024];
      for (i32 pass = 0; pass < 2; pass++) {
        const i32 sh = 40 + 10 * pass;
        memset(cnt, 0, sizeof cnt);
        for (i32 i = 0; i < sg.n; i++) cnt[(kv[i] >> sh) & 1023]++;
        u32 sum = 0;
        for (i32 k = 0; k < 1024; k++) { u32 t = cnt[k]; cnt[k] = sum; sum += t; }
        for (i32 i = 0; i < sg.n; i++) kb[cnt[(kv[i] >> sh) & 1023]++] = kv[i];
        std::swap(kv, kb);
      }
      // two swaps: kv points at the fully sorted buffer again
      i32 i = 0;
      while (i < sg.n) {
        u64 r1 = kv[i] >> 40;
        i32 j = i + 1;
        while (j < sg.n && (kv[j] >> 40) == r1) j++;
        i32 rn = j - i;
        if (rn > 600) {
          // long equal-r1 run (shallow depths on repetitive text):
          // finish with two 10-bit passes on r2 instead of introsort
          // (pass 1: kv -> kb on bits 20..29; pass 2: kb -> kv on 30..39)
          for (i32 pass = 0; pass < 2; pass++) {
            const i32 sh = 20 + 10 * pass;
            const u64* src = pass ? kb : kv;
            u64* dst = pass ? kv : kb;
            memset(cnt, 0, sizeof cnt);
            for (i32 t = i; t < j; t++) cnt[(src[t] >> sh) & 1023]++;
            u32 sum = 0;
            for (i32 k = 0; k < 1024; k++) {
              u32 t = cnt[k]; cnt[k] = sum; sum += t;
            }
            for (i32 t = i; t < j; t++)
              dst[i + cnt[(src[t] >> sh) & 1023]++] = src[t];
          }
        } else if (rn > 1) {
          std::sort(kv + i, kv + j);
        }
        i = j;
      }
    }
    for (i32 i = 0; i < sg.n; i++) a[i] = (i32)(kv[i] & 0xFFFFF);
    if (g_prof) {
      g_tsc_gather += t1 - t0; g_tsc_sort += __rdtsc() - t1;
      g_n_gather += sg.n; g_n_segs++;
    }
    // equal-(r1,r2) runs recurse `step` bytes deeper.
    // Refined ranks are WRITTEN BACK on split (Larsson–Sadakane-style):
    // every run after the first gets its new global run-start as its
    // members' partial rank, so later gathers — in this bucket and every
    // other — resolve deep ties without re-walking the tie.  The ISA
    // invariant is preserved: values are starts of disjoint, only-ever-
    // splitting refinement runs, so equality still means "same unfinished
    // run" and any two distinct values order consistently.
    i32 i = 0;
    while (i < sg.n) {
      u64 k = kv[i] >> 20;  // (r1, r2) pair
      i32 j = i + 1;
      while (j < sg.n && (kv[j] >> 20) == k) j++;
      if (i > 0) {  // first run keeps the segment's own (unchanged) rank
        // NOTE: the writeback must be unconditional — every member's
        // stored value must equal its own CURRENT run start, or a stale
        // ancestor start compared against a finalized exact slot inside
        // the same run orders inconsistently (a depth-gated variant of
        // this was bit-wrong on real corpus blocks).
        u32 nr = (u32)(gbase + sg.off + i);
        if (j - i > 1) {
          for (i32 t = i; t < j; t++) isa[a[t]] = nr;
        } else {
          isa[a[i]] = nr;  // singleton: exact slot
        }
      }
      if (j - i > 1) stack.push_back({sg.off + i, j - i, sg.depth + step});
      i = j;
    }
    if (g_prof) {
      i32 cl = size_class(sg.n);
      g_cls_tsc[cl] += __rdtsc() - tseg; g_cls_n[cl]++; g_cls_elems[cl] += sg.n;
    }
  }
  return true;
}

}  // namespace mkqs

// Sort the p rotations of the primitive root `s` into SA.  Returns false
// on budget bail (caller falls back to cyclic SA-IS).
//
// last_out (length p): the BWT last column of the root, emitted FOR FREE
// inside the copy-induction scans — those already load d[SA[j]-1] (the
// char preceding each rotation) for every slot of every big bucket, and
// the two scan fronts meet exactly, so every slot is visited once.  This
// replaces the encoder's separate 900k-gather last-column pass (~8 ms).
// k0_out: the exact SA slot of rotation 0 (== isa[0]; every bucket
// finalizes its members' ISA to exact slots), i.e. the BWT origin.
static bool mkqs_rotation_sort(const u8* s, i32* SA, i32 p,
                               u8* last_out, i32* k0_out) {
  if (p < 2) {
    if (p == 1) { SA[0] = 0; last_out[0] = s[0]; *k0_out = 0; }
    return p >= 1;
  }
  if (p >= (1 << 20)) return false;  // 20-bit key packing bound (cap 900000)
  const bool mdbg = getenv("BZ2TPU_MKQS_TIMING") != nullptr;
  struct timespec mt0;
  if (mdbg) clock_gettime(CLOCK_MONOTONIC, &mt0);
  mkqs::g_prof = mdbg;
  mkqs::g_tsc_gather = mkqs::g_tsc_sort = 0;
  mkqs::g_n_gather = mkqs::g_n_segs = 0;
  mkqs::g_max_depth = 0;
  memset(mkqs::g_cls_tsc, 0, sizeof mkqs::g_cls_tsc);
  memset(mkqs::g_cls_n, 0, sizeof mkqs::g_cls_n);
  memset(mkqs::g_cls_elems, 0, sizeof mkqs::g_cls_elems);
  double t_sort = 0, t_copy = 0;
  auto elapsed = [&]() {
    struct timespec t1;
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double dt = (t1.tv_sec - mt0.tv_sec) + 1e-9 * (t1.tv_nsec - mt0.tv_nsec);
    mt0 = t1;
    return dt;
  };
  // persistent buffers: fresh multi-MB allocations re-fault on this VM
  static thread_local std::vector<u8> dbuf;
  static thread_local std::vector<i32> ftab;
  static thread_local std::vector<u8> small_done;
  if ((i32)dbuf.size() < 2 * p + 16) dbuf.resize((size_t)2 * p + 16);
  memcpy(dbuf.data(), s, p);
  memcpy(dbuf.data() + p, s, p);
  memset(dbuf.data() + 2 * p, 0, 16);  // readable pad for key8 overreads
  const u8* d = dbuf.data();

  // 2-byte bucket pass.  All hot loops below go through raw pointers:
  // TLS object access from a dlopen'd .so pays __tls_get_addr per deref.
  ftab.assign(65537, 0);
  i32* const ft = ftab.data();
  {
    u32 k2 = d[0];
    for (i32 i = 0; i < p; i++) {
      k2 = ((k2 << 8) | d[i + 1]) & 0xFFFF;
      ft[k2]++;
    }
  }
  for (i32 k = 0; k < 65536; k++) ft[k + 1] += ft[k];
  // ftab[k] = end (exclusive) of bucket k; scatter from the back
  auto bstart = [ft](u32 k2) { return k2 ? ft[k2 - 1] : 0; };
  // partial ranks: small-bucket start per rotation; refined to the exact
  // SA slot as buckets finish (see invariant above).  Initialised inside
  // the scatter loop below — both index by the same rolling k2.
  static thread_local std::vector<u32> isa_buf;
  if ((i32)isa_buf.size() < p) isa_buf.resize(p);
  u32* const isa = isa_buf.data();
  {
    static thread_local std::vector<i32> fin_buf;
    fin_buf.assign(ftab.begin(), ftab.begin() + 65536);
    i32* const fin = fin_buf.data();
    for (i32 i = p - 1; i >= 0; i--) {
      u32 k2 = ((u32)d[i] << 8) | d[i + 1];
      SA[--fin[k2]] = i;
      isa[i] = (u32)(k2 ? ft[k2 - 1] : 0);
    }
  }
  auto finalize = [&](i32 lo, i32 hi) {  // ISA[rot] = exact slot
    for (i32 j = lo; j < hi; j++) {
      if (j + 16 < hi) __builtin_prefetch(&isa[SA[j + 16]], 1, 0);
      isa[SA[j]] = (u32)j;
    }
  };

  if (mdbg) fprintf(stderr, "[mkqs] buckets  %.4f\n", elapsed());
  static thread_local std::vector<mkqs::Seg> seg_stack;
  static thread_local std::vector<u64> kv_scratch, kv_scratch2;
  // budget: corpus blocks use <= ~1.8p (depth-weighted) visits —
  // writeback keeps refinement near-linear; repetitive adversaries burn
  // ~20ns/visit and their depth weighting compounds, so bailing at p*4
  // caps wasted work near one csais pass before the fallback runs
  mkqs::Ctx ctx{d, isa, p, (i64)p * 4 + (1 << 16),
                &seg_stack, &kv_scratch, &kv_scratch2};
  small_done.assign(65536, 0);
  bool big_done[256] = {};
  // big buckets smallest-first so copy-induction covers the heavy ones
  i32 order[256];
  for (i32 i = 0; i < 256; i++) order[i] = i;
  std::sort(order, order + 256, [&](i32 a, i32 b) {
    i32 sa2 = ft[((u32)a << 8) | 255] - bstart((u32)a << 8);
    i32 sb = ft[((u32)b << 8) | 255] - bstart((u32)b << 8);
    return sa2 < sb;
  });

  for (i32 oi = 0; oi < 256; oi++) {
    i32 ss = order[oi];
    // 1) quicksort each small bucket [ss, x], x != ss, not already
    // induced — smallest-first: each completed bucket publishes exact
    // ranks, and the depth profile shows most elements of LATER buckets
    // then settle in a single rank pass, so the cheap buckets should
    // subsidise the expensive ones, not the reverse
    i32 sml[256];
    for (i32 x = 0; x < 256; x++) sml[x] = x;
    std::sort(sml, sml + 256, [&](i32 a2, i32 b2) {
      u32 ka = ((u32)ss << 8) | (u32)a2, kb2 = ((u32)ss << 8) | (u32)b2;
      return ft[ka] - bstart(ka) < ft[kb2] - bstart(kb2);
    });
    for (i32 xi = 0; xi < 256; xi++) {
      i32 x = sml[xi];
      if (x == ss) continue;
      u32 k2 = ((u32)ss << 8) | (u32)x;
      if (small_done[k2]) continue;
      i32 lo = bstart(k2), hi = ft[k2];
      if (hi - lo > 1) {
        // writeback inside sort_bucket leaves every member's ISA at its
        // exact slot on completion — no finalize pass needed here
        if (!mkqs::sort_bucket(ctx, SA + lo, hi - lo, 2, lo)) {
          if (getenv("BZ2TPU_DEBUG_TIMING"))
            fprintf(stderr, "[mkqs] budget bail at big=%d small=%d\n", ss, x);
          return false;
        }
      } else if (hi - lo == 1) {
        isa[SA[lo]] = (u32)lo;
      }
      small_done[k2] = 1;
    }
    if (mdbg) t_sort += elapsed();
    // 2) copy-induction: fill [x, ss] for every x from the sorted big
    // bucket ss.  The ascending scan chases copy_start[ss] so the
    // self-referential [ss, ss] left side feeds itself; the descending
    // scan symmetric from the right; the two fronts meet exactly.
    i32 copy_start[256], copy_end[256];
    for (i32 x = 0; x < 256; x++) {
      u32 k2 = ((u32)x << 8) | (u32)ss;
      copy_start[x] = bstart(k2);
      copy_end[x] = ft[k2] - 1;
    }
    i32 big_lo = bstart((u32)ss << 8);
    i32 big_hi = ft[((u32)ss << 8) | 255];  // end (exclusive) of big ss
    for (i32 j = big_lo; j < copy_start[ss]; j++) {
      i32 k = SA[j] - 1;
      if (k < 0) k += p;
      i32 c1 = d[k];
      last_out[j] = (u8)c1;
      if (!big_done[c1]) SA[copy_start[c1]++] = k;
    }
    for (i32 j = big_hi - 1; j > copy_end[ss]; j--) {
      i32 k = SA[j] - 1;
      if (k < 0) k += p;
      i32 c1 = d[k];
      last_out[j] = (u8)c1;
      if (!big_done[c1]) SA[copy_end[c1]--] = k;
    }
    if (copy_start[ss] != copy_end[ss] + 1) {
      if (getenv("BZ2TPU_DEBUG_TIMING"))
        fprintf(stderr, "[mkqs] copy-front mismatch ss=%d\n", ss);
      return false;  // defensive
    }
    // newly induced [x, ss] buckets (and the self-filled [ss, ss]) are
    // final: publish their exact ranks for later buckets' tiebreaks
    for (i32 x = 0; x < 256; x++) {
      u32 k2 = ((u32)x << 8) | (u32)ss;
      if (!small_done[k2])
        finalize(bstart(k2), ft[k2]);
      small_done[k2] = 1;
    }
    big_done[ss] = true;
    if (mdbg) t_copy += elapsed();
  }
  *k0_out = (i32)isa[0];
  if (mdbg) {
    fprintf(stderr, "[mkqs] qsort    %.4f\n[mkqs] copy     %.4f\n"
                    "[mkqs] budget-used %lld\n",
            t_sort, t_copy,
            (long long)((i64)p * 4 + (1 << 16) - ctx.budget));
    fprintf(stderr,
            "[mkqsP] gather_Mtsc %.1f (n=%llu) "
            "sort_Mtsc %.1f segs=%llu\n",
            mkqs::g_tsc_gather / 1e6, (unsigned long long)mkqs::g_n_gather,
            mkqs::g_tsc_sort / 1e6, (unsigned long long)mkqs::g_n_segs);
    fprintf(stderr, "[mkqsP] max_depth %d\n", mkqs::g_max_depth);
    static const char* cls_name[6] = {"=2", "<=8", "<=40", "<=256",
                                      "<=2048", ">2048"};
    for (i32 cl = 0; cl < 6; cl++)
      if (mkqs::g_cls_n[cl])
        fprintf(stderr, "[mkqsC] %-6s segs=%-8llu elems=%-9llu Mtsc=%.1f\n",
                cls_name[cl], (unsigned long long)mkqs::g_cls_n[cl],
                (unsigned long long)mkqs::g_cls_elems[cl],
                mkqs::g_cls_tsc[cl] / 1e6);
  }
  return true;
}

extern "C" {

// dev-only timing hook: time one rotation sort (mode 0 = bucket+rank
// path, 1 = cyclic SA-IS).  Returns seconds, or -1 on budget bail.
double bz2tpu_sort_probe(const u8* block, i32 n, i32 mode) {
  std::vector<i32> SA(n);
  std::vector<u8> lastc(n);
  i32 k0 = 0;
  struct timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  bool ok = true;
  if (mode == 0) ok = mkqs_rotation_sort(block, SA.data(), n, lastc.data(), &k0);
  else csais_t<u8>(block, SA.data(), n, 256);
  clock_gettime(CLOCK_MONOTONIC, &t1);
  if (!ok) return -1.0;
  return (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
}

// ----------------------------------------------------- native block encode --
struct BitWr {
  u8* p;
  i64 cap, len = 0;
  u64 acc = 0;
  int nb = 0;
  bool overflow = false;
  void put(u32 v, int k) {
    acc = (acc << k) | (u64)(k >= 32 ? v : (v & ((1u << k) - 1)));
    nb += k;
    if (nb >= 32) {  // MSB-first: flush the top 32 bits as 4 bytes
      if (len + 4 > cap) { overflow = true; nb = 0; return; }
      u32 w = __builtin_bswap32((u32)(acc >> (nb - 32)));
      memcpy(p + len, &w, 4);
      len += 4;
      nb -= 32;
    }
  }
  i64 finish() {  // returns total bits; pads the final byte with low zeros
    while (nb >= 8) {
      if (len >= cap) { overflow = true; return -1; }
      p[len++] = (u8)(acc >> (nb - 8));
      nb -= 8;
    }
    i64 bits = len * 8 + nb;
    if (nb) {
      if (len >= cap) { overflow = true; return -1; }
      p[len++] = (u8)(acc << (8 - nb));
      nb = 0;
    }
    return bits;
  }
};

// Encode one RLE1 block (post-RLE1 bytes + metadata) into its bit payload
// (reference wire layout, documented in oracle/block.py).  Returns the
// payload bit count, or a negative BZT_* error.  out must hold at least
// 3*n + (1 << 16) bytes.
i64 bz2tpu_encode_block(const u8* block, i32 n, const u8* in_use, u32 crc,
                        u8* out, i64 out_cap) {
  if (n < 1) return BZT_DATA_ERROR;
  const bool dbg = getenv("BZ2TPU_DEBUG_TIMING") != nullptr;
  struct timespec t0, t1;
  auto lap = [&](const char* what) {
    if (!dbg) return;
    clock_gettime(CLOCK_MONOTONIC, &t1);
    fprintf(stderr, "[enc] %-8s %.3fs\n", what,
            (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec));
    t0 = t1;
  };
  if (dbg) clock_gettime(CLOCK_MONOTONIC, &t0);

  // --- rotation sort.  KMP minimal period first: an exactly-periodic
  // block (m = n/p > 1 copies of a primitive root) repeats each root
  // rotation m times with identical last characters, so sorting the p root
  // rotations suffices (and turns the periodic worst case into an O(p)
  // sort).  Primitive blocks go straight to the cyclic SA-IS.
  //
  // origPtr on tied (equal) rotations is unconstrained by the format —
  // any in-class slot decodes identically and the stream sizes match.  We
  // pick the LAST in-class slot (class base + m - 1), which empirically
  // matches stock bzip2 on every regular periodic family tested: periods
  // 2/3/5/251, block-filling and sub-block, levels 1 and 9, plus
  // all-equal tiny blocks (tests/test_periodic.py).  The adversarial
  // residue (chaotic fallbackQSort3 slots; the reference fork's
  // divsufsort disagrees with stock here too) is corrected at the
  // payload layer by bzip2_tpu/periodic.py's black-box stock probe, so
  // the emitted stream is fully bit-exact (see oracle/bwt.py).
  // persistent buffers: fresh multi-MB allocations re-fault on this VM
  static thread_local std::vector<u8> last;
  if ((i32)last.size() < n) last.resize(n);
  i32 orig_ptr;
  i32 p = n;
  {
    // minimal period that DIVIDES n == smallest divisor d with
    // block[0..n-d) == block[d..n).  Probing 64 bytes per divisor first
    // rejects primitive blocks (the overwhelmingly common case) in a few
    // hundred ns, vs the serial O(n) KMP failure-function scan.
    i32 divs[1600];
    i32 nd = 0;
    for (i32 a = 1; (i64)a * a <= n; a++) {
      if (n % a) continue;
      divs[nd++] = a;
      if (a != n / a && n / a < n) divs[nd++] = n / a;
    }
    std::sort(divs, divs + nd);
    for (i32 di = 0; di < nd; di++) {
      i32 d = divs[di];
      if (d == n) break;
      i32 probe = n - d < 64 ? n - d : 64;
      if (memcmp(block, block + d, probe)) continue;
      if (!memcmp(block, block + d, n - d)) { p = d; break; }
    }
  }
  lap("period");
  i32 m = n / p;
  if (p == 1) {
    memset(last.data(), block[0], n);
    orig_ptr = n - 1;
  } else {
    static thread_local std::vector<i32> SA_buf;
    if ((i32)SA_buf.size() < p) {
      SA_buf.resize(p);
      advise_huge(SA_buf.data(), (size_t)p * 4);
    }
    std::vector<i32>& SA = SA_buf;
    bool fused = false;   // mkqs emitted last column + k0 itself
    i32 k0 = 0;
    if (getenv("BZ2TPU_SAIS_DOUBLED")) {
      // differential-fuzz reference path: doubled-string SA-IS on the
      // (primitive) root; must order rotations identically to csais_t
      i32 p2 = 2 * p + 1;
      std::vector<u16> s(p2);
      std::vector<i32> SA2(p2);
      for (i32 i = 0; i < p; i++) {
        s[i] = (u16)(block[i] + 1);
        s[p + i] = (u16)(block[i] + 1);
      }
      s[p2 - 1] = 0;
      sais_t<u16>(s.data(), SA2.data(), p2, 258);
      i32 k = 0;
      for (i32 i = 0; i < p2; i++)
        if (SA2[i] < p) SA[k++] = SA2[i];
    } else {
      // default: bucket+MKQS+copy sorter (env BZ2TPU_SAIS forces the
      // cyclic SA-IS; the MKQS path bails to it on deep-repeat budget).
      // m == 1 (primitive block, the common case): the sorter writes the
      // BWT last column straight into `last` during its copy scans
      static thread_local std::vector<u8> rootlast_buf;
      u8* lout = last.data();
      if (m != 1) {
        if ((i32)rootlast_buf.size() < p) rootlast_buf.resize(p);
        lout = rootlast_buf.data();
      }
      if (!getenv("BZ2TPU_SAIS")
          && mkqs_rotation_sort(block, SA.data(), p, lout, &k0)) {
        fused = true;
        if (m != 1) {  // expand each root char m times
          u8* lp = last.data();
          for (i32 k = 0; k < p; k++) { memset(lp, lout[k], m); lp += m; }
        }
      } else {
        csais_t<u8>(block, SA.data(), p, 256);
      }
    }
    lap("sort");
    if (!fused) {  // csais / doubled paths: gather the last column from SA
      u8* lp = last.data();
      for (i32 k = 0; k < p; k++) {
        if (k + 24 < p) __builtin_prefetch(block + SA[k + 24], 0, 0);
        i32 j = SA[k];
        if (j == 0) k0 = k;
        u8 ch = block[j ? j - 1 : p - 1];
        if (m == 1) {
          *lp++ = ch;
        } else {
          memset(lp, ch, m);
          lp += m;
        }
      }
    }
    orig_ptr = k0 * m + (m - 1);
  }
  lap("sais");

  // --- MTF + RLE2 over the used alphabet.
  u8 remap[256];
  u8 mtf[256];
  i32 n_used = 0;
  for (i32 c = 0; c < 256; c++)
    if (in_use[c]) { remap[c] = (u8)n_used; mtf[n_used] = (u8)n_used; n_used++; }
  if (n_used == 0) return BZT_DATA_ERROR;
  i32 alpha = n_used + 2;
  i32 eob = n_used + 1;

  // persistent buffer, but hot loops go through a raw pointer: TLS
  // object access from a dlopen'd .so pays __tls_get_addr per deref
  static thread_local std::vector<u16> mtfv_buf;
  if ((i64)mtfv_buf.size() < (i64)n + 8) mtfv_buf.resize(n + 8);
  u16* const mtfv = mtfv_buf.data();
  i64 n_mtf = 0;
  const u8* const lastd = last.data();
  i32 freq[258];
  memset(freq, 0, sizeof freq);
  i64 zrun = 0;
  auto flush_run = [&]() {
    // bijective base-2: Z emits floor(log2(Z+1)) digits, digit_j =
    // ((Z+1) >> j) & 1 (0 = RUNA, 1 = RUNB)
    i64 m = zrun + 1;
    while (m >= 2) {
      u16 d = (u16)(m & 1);
      mtfv[n_mtf++] = d;
      freq[d]++;
      m >>= 1;
    }
    zrun = 0;
  };
  for (i32 i = 0; i < n; i++) {
    u8 sym = remap[lastd[i]];
    if (mtf[0] == sym) { zrun++; continue; }
    i32 p;
#ifdef __AVX2__
    {  // SIMD rank search: one 32-byte compare covers the common case
      const __m256i t = _mm256_set1_epi8((char)sym);
      p = 0;
      for (i32 c = 0; ; c += 32) {
        u32 m = (u32)_mm256_movemask_epi8(_mm256_cmpeq_epi8(
            _mm256_loadu_si256((const __m256i*)(mtf + c)), t));
        if (m) { p = c + (i32)__builtin_ctz(m); break; }
      }
    }
#else
    p = 1;
    while (mtf[p] != sym) p++;
#endif
    if (zrun) flush_run();
    if (p <= 16) {
      for (i32 q = p; q > 0; q--) mtf[q] = mtf[q - 1];
    } else {
      memmove(mtf + 1, mtf, p);
    }
    mtf[0] = sym;
    mtfv[n_mtf++] = (u16)(p + 1);
    freq[p + 1]++;
  }
  if (zrun) flush_run();
  mtfv[n_mtf++] = (u16)eob;
  freq[eob]++;
  lap("mtf");

  // --- greedy 6-table search (oracle/groups.py semantics).
  i32 n_groups = n_mtf < 200 ? 2 : n_mtf < 600 ? 3 : n_mtf < 1200 ? 4
                 : n_mtf < 2400 ? 5 : 6;
  i32 lens[6][258];
  {  // frequency-partition seeding
    for (i32 t2 = 0; t2 < n_groups; t2++)
      for (i32 v = 0; v < alpha; v++) lens[t2][v] = 15;  // GREATER_ICOST
    i32 n_part = n_groups, gs = 0;
    i64 rem_f = n_mtf;
    while (n_part > 0) {
      i64 t_freq = rem_f / n_part;
      i32 ge = gs - 1;
      i64 a_freq = 0;
      while (a_freq < t_freq && ge < alpha - 1) a_freq += freq[++ge];
      if (ge > gs && n_part != n_groups && n_part != 1
          && ((n_groups - n_part) % 2 == 1)) {
        a_freq -= freq[ge--];
      }
      for (i32 v = gs; v <= ge; v++) lens[n_part - 1][v] = 0;  // LESSER_ICOST
      n_part--;
      gs = ge + 1;
      rem_f -= a_freq;
    }
  }
  i64 n_sel = (n_mtf + 49) / 50;
  if (n_sel > 18002) return BZT_DATA_ERROR;
  std::vector<u8> selectors(n_sel);
  i32 new_freq[6][258];
  for (i32 it = 0; it < 4; it++) {
    memset(new_freq, 0, sizeof new_freq);
#ifdef __SSE2__
    // transpose lens to one 8x16-bit row per symbol: the 50-symbol cost
    // accumulation becomes one load + one vector add per symbol (6 lanes
    // live; max sum 50*23 fits u16)
    alignas(16) u16 lens_pack[258][8];
    for (i32 v = 0; v < alpha; v++) {
      for (i32 t2 = 0; t2 < 6; t2++)
        lens_pack[v][t2] = (u16)(t2 < n_groups ? lens[t2][v] : 0);
      lens_pack[v][6] = lens_pack[v][7] = 0;
    }
    for (i64 g = 0; g < n_sel; g++) {
      i64 lo = g * 50, hi = lo + 50 < n_mtf ? lo + 50 : n_mtf;
      __m128i acc = _mm_setzero_si128();
      for (i64 i = lo; i < hi; i++)
        acc = _mm_add_epi16(
            acc, _mm_load_si128((const __m128i*)lens_pack[mtfv[i]]));
      alignas(16) u16 cost[8];
      _mm_store_si128((__m128i*)cost, acc);
      i32 best = 0;
      for (i32 t2 = 1; t2 < n_groups; t2++)
        if (cost[t2] < cost[best]) best = t2;   // first minimum wins
      selectors[g] = (u8)best;
      for (i64 i = lo; i < hi; i++) new_freq[best][mtfv[i]]++;
    }
#else
    for (i64 g = 0; g < n_sel; g++) {
      i64 lo = g * 50, hi = lo + 50 < n_mtf ? lo + 50 : n_mtf;
      i32 cost[6] = {0, 0, 0, 0, 0, 0};
      for (i64 i = lo; i < hi; i++) {
        u16 sym = mtfv[i];
        for (i32 t2 = 0; t2 < n_groups; t2++) cost[t2] += lens[t2][sym];
      }
      i32 best = 0;
      for (i32 t2 = 1; t2 < n_groups; t2++)
        if (cost[t2] < cost[best]) best = t2;   // first minimum wins
      selectors[g] = (u8)best;
      for (i64 i = lo; i < hi; i++) new_freq[best][mtfv[i]]++;
    }
#endif
    for (i32 t2 = 0; t2 < n_groups; t2++)
      huff_lengths_one(new_freq[t2], alpha, 17, lens[t2]);
  }

  lap("groups");

  // canonical codes: ascending length, then symbol order
  u32 codes[6][258];
  for (i32 t2 = 0; t2 < n_groups; t2++) {
    i32 mn = 32, mx = 0;
    for (i32 v = 0; v < alpha; v++) {
      if (lens[t2][v] < mn) mn = lens[t2][v];
      if (lens[t2][v] > mx) mx = lens[t2][v];
    }
    u32 vec = 0;
    for (i32 L = mn; L <= mx; L++) {
      for (i32 v = 0; v < alpha; v++)
        if (lens[t2][v] == L) codes[t2][v] = vec++;
      vec <<= 1;
    }
  }

  // --- serialize.
  BitWr w{out, out_cap};
  w.put(0x314159u, 24);
  w.put(0x265359u, 24);
  w.put(crc, 32);
  w.put(0, 1);
  w.put((u32)orig_ptr, 24);
  u32 gmap = 0;
  for (i32 g = 0; g < 16; g++) {
    for (i32 j = 0; j < 16; j++)
      if (in_use[g * 16 + j]) { gmap |= 1u << (15 - g); break; }
  }
  w.put(gmap, 16);
  for (i32 g = 0; g < 16; g++) {
    if (!(gmap & (1u << (15 - g)))) continue;
    u32 bits = 0;
    for (i32 j = 0; j < 16; j++)
      if (in_use[g * 16 + j]) bits |= 1u << (15 - j);
    w.put(bits, 16);
  }
  w.put((u32)n_groups, 3);
  w.put((u32)n_sel, 15);
  {  // selector MTF, unary codes
    u8 pos[6];
    for (i32 t2 = 0; t2 < n_groups; t2++) pos[t2] = (u8)t2;
    for (i64 g = 0; g < n_sel; g++) {
      u8 v = selectors[g];
      i32 p = 0;
      while (pos[p] != v) p++;
      for (i32 j2 = p; j2 > 0; j2--) pos[j2] = pos[j2 - 1];
      pos[0] = v;
      // value p+1 -> p ones then a zero: pattern (1<<(p+1))-2 in p+1 bits
      w.put((1u << (p + 1)) - 2, p + 1);
    }
  }
  for (i32 t2 = 0; t2 < n_groups; t2++) {  // delta-coded length tables
    i32 curr = lens[t2][0];
    w.put((u32)curr, 5);
    for (i32 v = 0; v < alpha; v++) {
      while (curr < lens[t2][v]) { w.put(2, 2); curr++; }
      while (curr > lens[t2][v]) { w.put(3, 2); curr--; }
      w.put(0, 1);
    }
  }
  for (i64 g0 = 0; g0 < n_mtf; g0 += 50) {  // payload, group-blocked
    i32 t2 = selectors[g0 / 50];
    const u32* cd = codes[t2];
    const i32* ln = lens[t2];
    i64 hi = g0 + 50 < n_mtf ? g0 + 50 : n_mtf;
    i64 i = g0;
    for (; i + 1 < hi; i += 2) {  // pair symbols when they fit one put
      u16 s1 = mtfv[i], s2 = mtfv[i + 1];
      i32 l1 = ln[s1], l2 = ln[s2];
      if (l1 + l2 <= 32) {
        w.put((cd[s1] << l2) | cd[s2], l1 + l2);
      } else {
        w.put(cd[s1], l1);
        w.put(cd[s2], l2);
      }
    }
    for (; i < hi; i++) w.put(cd[mtfv[i]], ln[mtfv[i]]);
  }
  i64 bits = w.finish();
  lap("pack");
  if (w.overflow) return BZT_MEM_ERROR;
  return bits;
}

// ------------------------------------ stock-dynamics periodic origPtr --
// On an exactly-periodic block every rotation in a tie class is the same
// string, so which in-class slot the 24-bit origPtr field names is pure
// sorter dynamics.  This repo's bit-exactness oracle is stock bzip2
// (stdlib bz2 == libbz2 1.0.8); stock reaches its O(N log^2 N) fallback
// sorter on every exactly-periodic block (blocks < 10k bytes use it
// directly; larger ones always exhaust mainSort's nblock*((wf-1)/3)
// budget, since each of the >= n-p identical-rotation compares costs
// ~n/8).  The fallback is a Manber-Myers bucket-refinement sort whose
// per-bucket 3-way quicksort picks pivots from a fixed LCG
// (r = (7621 r + 1) mod 32768, per Sedgewick ch. 35) — deterministic,
// so replaying the same dynamics reproduces the slot exactly.  Behavior
// studied from the upstream lineage diff shipped with the reference
// (blocksort.c.diff.gz: fallbackSort / fallbackQSort3 /
// fallbackSimpleSort); implementation fresh.  Every decision below is
// pinned by tests/test_periodic.py's stock cross-check sweep.

namespace fbsort {

// insertion sort of ord[lo..hi] by cls[ord[.]]: one gap-4 pre-pass then a
// gap-1 pass, both scanning the insert index downward (the exact scan
// order matters — equal keys keep their relative order per pass, but the
// two-pass composition is what stock does).
static void insertion(i32* ord, const i32* cls, i32 lo, i32 hi) {
  if (lo == hi) return;
  if (hi - lo > 3) {
    for (i32 i = hi - 4; i >= lo; i--) {
      i32 t = ord[i], v = cls[t], j;
      for (j = i + 4; j <= hi && v > cls[ord[j]]; j += 4) ord[j - 4] = ord[j];
      ord[j - 4] = t;
    }
  }
  for (i32 i = hi - 1; i >= lo; i--) {
    i32 t = ord[i], v = cls[t], j;
    for (j = i + 1; j <= hi && v > cls[ord[j]]; j++) ord[j - 1] = ord[j];
    ord[j - 1] = t;
  }
}

// 3-way quicksort with LCG pivot selection.  The equal-to-pivot blocks
// are parked at both ends during partition and swapped into the middle
// after; the larger side is pushed first (LIFO -> smaller side recurses
// first).  All of this shuffles equal elements deterministically, which
// is exactly the dynamics the origPtr slot depends on.
static void qsort3(i32* ord, const i32* cls, i32 lo0, i32 hi0) {
  u32 rng = 0;
  std::vector<std::pair<i32, i32>> st;
  st.reserve(128);
  st.emplace_back(lo0, hi0);
  while (!st.empty()) {
    i32 lo = st.back().first, hi = st.back().second;
    st.pop_back();
    if (hi - lo < 10) {
      insertion(ord, cls, lo, hi);
      continue;
    }
    rng = (rng * 7621 + 1) % 32768;
    u32 sel = rng % 3;
    i32 med = cls[ord[sel == 0 ? lo : sel == 1 ? (lo + hi) >> 1 : hi]];
    i32 uLo = lo, eqLo = lo, uHi = hi, eqHi = hi;
    for (;;) {
      while (uLo <= uHi) {
        i32 d = cls[ord[uLo]] - med;
        if (d == 0) { std::swap(ord[uLo], ord[eqLo]); eqLo++; uLo++; continue; }
        if (d > 0) break;
        uLo++;
      }
      while (uLo <= uHi) {
        i32 d = cls[ord[uHi]] - med;
        if (d == 0) { std::swap(ord[uHi], ord[eqHi]); eqHi--; uHi--; continue; }
        if (d < 0) break;
        uHi--;
      }
      if (uLo > uHi) break;
      std::swap(ord[uLo], ord[uHi]);
      uLo++;
      uHi--;
    }
    if (eqHi < eqLo) continue;  // everything equal to the pivot
    i32 a = std::min(eqLo - lo, uLo - eqLo);
    for (i32 t = 0; t < a; t++) std::swap(ord[lo + t], ord[uLo - a + t]);
    i32 b = std::min(hi - eqHi, eqHi - uHi);
    for (i32 t = 0; t < b; t++) std::swap(ord[uLo + t], ord[hi - b + 1 + t]);
    i32 nl = lo + (uLo - eqLo) - 1;
    i32 mh = hi - (eqHi - uHi) + 1;
    if (nl - lo > hi - mh) {
      st.emplace_back(lo, nl);
      st.emplace_back(mh, hi);
    } else {
      st.emplace_back(mh, hi);
      st.emplace_back(lo, nl);
    }
  }
}

}  // namespace fbsort

// Rotation-sort the block with stock's fallback dynamics and return the
// sorted index of rotation 0 (== the origPtr stock emits when it takes
// this path), or -1 on invalid input.
i64 bz2tpu_fallback_origptr(const u8* blk, i32 n) {
  if (n < 1) return -1;
  if (n == 1) return 0;
  std::vector<i32> ord(n), cls(n);
  std::vector<u32> bh((n + 64) / 32 + 2, 0);
  auto bit = [&](i64 z) -> bool { return (bh[z >> 5] >> (z & 31)) & 1; };
  auto setb = [&](i64 z) { bh[z >> 5] |= 1u << (z & 31); };

  // initial 1-byte counting sort; each bucket fills end -> start as the
  // position scan ascends (bucket content in descending position order)
  i32 ft[257];
  memset(ft, 0, sizeof ft);
  for (i32 i = 0; i < n; i++) ft[blk[i] + 1]++;
  for (i32 i = 1; i < 257; i++) ft[i] += ft[i - 1];
  i32 ends[256];
  for (i32 c = 0; c < 256; c++) ends[c] = ft[c + 1];
  for (i32 i = 0; i < n; i++) ord[--ends[blk[i]]] = i;
  for (i32 c = 0; c < 256; c++) setb(ends[c]);  // == bucket starts now
  // sentinels past the block: alternating set bits stop the scans
  for (i32 i = 0; i < 32; i++) setb(n + 2 * i);

  for (i32 H = 1;;) {
    // class of position k = start index of the rank bucket holding k+H
    i32 j = 0;
    for (i32 i = 0; i < n; i++) {
      if (bit(i)) j = i;
      i32 k = ord[i] - H;
      if (k < 0) k += n;
      cls[k] = j;
    }
    i64 not_done = 0;
    i32 r = -1;
    for (;;) {
      // bracket the next non-singleton bucket [l, r]: skip the run of
      // boundary bits, then the clear run inside the bucket, one bit at a
      // time (this replay only ever runs on n < 10000 blocks, so plain
      // scans are plenty; the alternating sentinel bits past n bound both)
      i64 k = r + 1;
      while (bit(k)) k++;
      i64 l = k - 1;
      if (l >= n) break;
      while (!bit(k)) k++;
      if (k - 1 >= n) break;
      r = (i32)(k - 1);
      if (r > l) {
        not_done += r - l + 1;
        fbsort::qsort3(ord.data(), cls.data(), (i32)l, r);
        i32 cc = -1;  // split the bucket at refined-class boundaries
        for (i32 i = (i32)l; i <= r; i++) {
          i32 c1 = cls[ord[i]];
          if (c1 != cc) { setb(i); cc = c1; }
        }
      }
    }
    H *= 2;
    if (H > n || not_done == 0) break;
  }
  for (i32 i = 0; i < n; i++)
    if (ord[i] == 0) return i;
  return -1;
}

}  // extern "C"
