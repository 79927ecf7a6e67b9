// nucio: native BAM/BGZF ingest for nucleoatac-jax.
//
// Native replacement for the reference's pysam/htslib substrate
// (SURVEY.md §3.4 item 2): one streaming pass over a coordinate-sorted
// paired-end BAM producing per-chromosome (fragment left, size) arrays,
// with multithreaded BGZF block inflation (the decompress is the ingest
// bottleneck; BAM records must still be parsed in stream order because
// they span block boundaries).
//
// Filters per DESIGN.md §1: proper pair, primary, mapq, tlen>0, ATAC
// +4/-5 offsets applied here so downstream sees adjusted fragments.
//
// C ABI for ctypes (see binding.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Block {
  std::vector<uint8_t> comp;  // raw deflate payload
  uint32_t isize = 0;         // uncompressed size (from BGZF footer)
};

// Read one BGZF block from fp. Returns false on clean EOF, throws
// std::string on corruption.
bool read_block(FILE* fp, Block* out) {
  uint8_t hdr[12];
  size_t n = fread(hdr, 1, 12, fp);
  if (n == 0) return false;
  if (n < 12 || hdr[0] != 0x1f || hdr[1] != 0x8b)
    throw std::string("bad BGZF header");
  uint16_t xlen = hdr[10] | (hdr[11] << 8);
  std::vector<uint8_t> extra(xlen);
  if (fread(extra.data(), 1, xlen, fp) != xlen)
    throw std::string("truncated BGZF extra field");
  int bsize = -1;
  for (size_t i = 0; i + 4 <= extra.size();) {
    uint8_t si1 = extra[i], si2 = extra[i + 1];
    uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
    if (si1 == 'B' && si2 == 'C' && slen == 2)
      bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
    i += 4 + slen;
  }
  if (bsize < 0) throw std::string("missing BGZF BC subfield");
  size_t cdata_len = static_cast<size_t>(bsize) - 12 - xlen - 8;
  out->comp.resize(cdata_len);
  if (fread(out->comp.data(), 1, cdata_len, fp) != cdata_len)
    throw std::string("truncated BGZF block");
  uint8_t tail[8];
  if (fread(tail, 1, 8, fp) != 8) throw std::string("truncated BGZF footer");
  out->isize = tail[4] | (tail[5] << 8) | (tail[6] << 16) |
               (uint32_t(tail[7]) << 24);
  return true;
}

void inflate_block(const Block& b, uint8_t* dst) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) throw std::string("inflateInit2 failed");
  zs.next_in = const_cast<uint8_t*>(b.comp.data());
  zs.avail_in = static_cast<uInt>(b.comp.size());
  zs.next_out = dst;
  zs.avail_out = b.isize;
  int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (ret != Z_STREAM_END && !(ret == Z_OK && b.isize == 0))
    throw std::string("inflate failed");
}

struct RefFrags {
  std::string name;
  int64_t length = 0;
  std::vector<int32_t> lefts;
  std::vector<int32_t> sizes;
};

constexpr uint16_t kRequired = 0x1 | 0x2;
constexpr uint16_t kFilterOut = 0x4 | 0x8 | 0x100 | 0x200 | 0x400 | 0x800;

struct Scanner {
  int min_mapq, max_size, shift, shrink;
  std::vector<RefFrags> refs;
  // streaming state
  std::vector<uint8_t> buf;  // unparsed decompressed bytes
  bool header_done = false;

  void parse(const uint8_t* data, size_t len, bool final) {
    buf.insert(buf.end(), data, data + len);
    size_t off = 0;
    if (!header_done) {
      if (!try_parse_header(&off)) return;  // need more bytes
      header_done = true;
    }
    while (true) {
      if (buf.size() - off < 4) break;
      uint32_t block_size;
      std::memcpy(&block_size, buf.data() + off, 4);
      if (buf.size() - off < 4 + block_size) break;
      const uint8_t* rec = buf.data() + off + 4;
      handle_record(rec, block_size);
      off += 4 + block_size;
    }
    buf.erase(buf.begin(), buf.begin() + off);
    if (final && !buf.empty()) throw std::string("trailing bytes in BAM");
  }

  bool try_parse_header(size_t* off_out) {
    // returns true when the full header is available and consumed
    const uint8_t* p = buf.data();
    size_t n = buf.size();
    if (n < 12) return false;
    if (std::memcmp(p, "BAM\x01", 4) != 0) throw std::string("not a BAM file");
    uint32_t l_text;
    std::memcpy(&l_text, p + 4, 4);
    size_t off = 8 + l_text;
    if (n < off + 4) return false;
    uint32_t n_ref;
    std::memcpy(&n_ref, p + off, 4);
    off += 4;
    std::vector<RefFrags> tmp(n_ref);
    for (uint32_t i = 0; i < n_ref; i++) {
      if (n < off + 4) return false;
      uint32_t l_name;
      std::memcpy(&l_name, p + off, 4);
      off += 4;
      if (n < off + l_name + 4) return false;
      tmp[i].name.assign(reinterpret_cast<const char*>(p + off), l_name - 1);
      off += l_name;
      uint32_t l_ref;
      std::memcpy(&l_ref, p + off, 4);
      tmp[i].length = l_ref;
      off += 4;
    }
    refs = std::move(tmp);
    *off_out = off;
    return true;
  }

  void handle_record(const uint8_t* r, uint32_t len) {
    if (len < 32) throw std::string("short BAM record");
    int32_t ref_id, pos, tlen;
    std::memcpy(&ref_id, r, 4);
    std::memcpy(&pos, r + 4, 4);
    uint8_t mapq = r[9];
    uint16_t flag;
    std::memcpy(&flag, r + 14, 2);
    std::memcpy(&tlen, r + 28, 4);
    if (ref_id < 0 || static_cast<size_t>(ref_id) >= refs.size()) return;
    if ((flag & kRequired) != kRequired || (flag & kFilterOut)) return;
    if (tlen <= 0 || mapq < min_mapq) return;
    int32_t size = tlen - shrink;
    if (size < 1 || size > max_size) return;
    refs[ref_id].lefts.push_back(pos + shift);
    refs[ref_id].sizes.push_back(size);
  }
};

}  // namespace

struct NucioBam {
  std::vector<RefFrags> refs;
  std::string error;
};

extern "C" {

NucioBam* nucio_scan_bam(const char* path, int min_mapq, int max_size,
                         int atac, int n_threads) {
  auto* out = new NucioBam();
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    out->error = "cannot open file";
    return out;
  }
  Scanner sc;
  sc.min_mapq = min_mapq;
  sc.max_size = max_size;
  sc.shift = atac ? 4 : 0;
  sc.shrink = atac ? 9 : 0;
  if (n_threads < 1) n_threads = 1;

  try {
    const size_t kChunkBlocks = 256;
    std::vector<Block> blocks;
    blocks.reserve(kChunkBlocks);
    bool eof = false;
    while (!eof) {
      blocks.clear();
      while (blocks.size() < kChunkBlocks) {
        Block b;
        if (!read_block(fp, &b)) {
          eof = true;
          break;
        }
        blocks.push_back(std::move(b));
      }
      if (blocks.empty()) break;
      std::vector<size_t> offsets(blocks.size() + 1, 0);
      for (size_t i = 0; i < blocks.size(); i++)
        offsets[i + 1] = offsets[i] + blocks[i].isize;
      std::vector<uint8_t> plain(offsets.back());
      std::string thread_err;
      if (n_threads == 1 || blocks.size() < 4) {
        for (size_t i = 0; i < blocks.size(); i++)
          inflate_block(blocks[i], plain.data() + offsets[i]);
      } else {
        std::atomic<size_t> next{0};
        std::vector<std::thread> pool;
        std::atomic<bool> failed{false};
        for (int t = 0; t < n_threads; t++) {
          pool.emplace_back([&] {
            while (true) {
              size_t i = next.fetch_add(1);
              if (i >= blocks.size() || failed.load()) return;
              try {
                inflate_block(blocks[i], plain.data() + offsets[i]);
              } catch (const std::string&) {
                failed.store(true);
                return;
              }
            }
          });
        }
        for (auto& th : pool) th.join();
        if (failed.load()) throw std::string("inflate failed");
      }
      sc.parse(plain.data(), plain.size(), eof);
    }
    out->refs = std::move(sc.refs);
  } catch (const std::string& e) {
    out->error = e;
  }
  fclose(fp);
  return out;
}

const char* nucio_error(NucioBam* b) {
  return b->error.empty() ? nullptr : b->error.c_str();
}
int nucio_n_refs(NucioBam* b) { return static_cast<int>(b->refs.size()); }
const char* nucio_ref_name(NucioBam* b, int i) { return b->refs[i].name.c_str(); }
long nucio_ref_len(NucioBam* b, int i) { return b->refs[i].length; }
long nucio_n_frags(NucioBam* b, int i) {
  return static_cast<long>(b->refs[i].lefts.size());
}
void nucio_copy_frags(NucioBam* b, int i, int32_t* lefts, int32_t* sizes) {
  const auto& r = b->refs[i];
  std::memcpy(lefts, r.lefts.data(), r.lefts.size() * 4);
  std::memcpy(sizes, r.sizes.data(), r.sizes.size() * 4);
}
void nucio_free(NucioBam* b) { delete b; }

// Batch delta-encoder for the device wire format (models/data.py ::
// DeltaBatch): entry = (delta, size) uint8 pair, gaps > 255 bp split
// into (255, 0) skip entries, size == 0 marks skip/padding. Semantics
// identical to the numpy encode_delta_fragments (nskip = d / 255, real
// entry advances d % 255). `out` [B, n_entries, 2] must be ZEROED by the
// caller (padding relies on the zero size bytes). counts[b] = valid
// fragments in row b of the [B, F] mids/sizes arrays.
// Returns 0 ok, -1 entry overflow, -2 unsorted/negative midpoints.
int nucio_encode_delta(const int32_t* mids, const int32_t* sizes,
                       const int64_t* counts, int B, int F,
                       uint8_t* out, int n_entries) {
  for (int b = 0; b < B; ++b) {
    const int32_t* m = mids + static_cast<size_t>(b) * F;
    const int32_t* s = sizes + static_cast<size_t>(b) * F;
    uint8_t* o = out + static_cast<size_t>(b) * n_entries * 2;
    long n = counts[b];
    long k = 0;
    int prev = 0;
    for (long i = 0; i < n; ++i) {
      int d = m[i] - prev;
      if (d < 0) return -2;
      long nskip = d / 255;
      if (k + nskip + 1 > n_entries) return -1;
      for (long j = 0; j < nskip; ++j) {
        o[2 * k] = 255;  // size byte stays 0 (pre-zeroed)
        ++k;
      }
      o[2 * k] = static_cast<uint8_t>(d - nskip * 255);
      int sz = s[i];
      o[2 * k + 1] = static_cast<uint8_t>(sz > 255 ? 255 : sz);
      ++k;
      prev = m[i];
    }
  }
  return 0;
}

// Wire-v6 batch encoder: 12-bit records (4-bit midpoint-delta nibble
// plane, then size-byte plane) — models/data.py :: encode_delta12_batch.
// A fragment record advances by its nibble (0..14); gaps > 14 bp are
// split into skip records (size byte 0) each advancing nibble*15
// (<= 225 bp). out row layout: [E/2 nibble bytes][E size bytes], E even.
// Returns 0, -1 on capacity overflow, -2 on unsorted mids.
int nucio_encode_delta12(const int32_t* mids, const int32_t* sizes,
                         const int64_t* counts, int B, int F,
                         uint8_t* out, int n_entries) {
  const int nb = n_entries / 2;
  const size_t row_bytes = static_cast<size_t>(nb) + n_entries;
  for (int b = 0; b < B; ++b) {
    const int32_t* m = mids + static_cast<size_t>(b) * F;
    const int32_t* s = sizes + static_cast<size_t>(b) * F;
    uint8_t* o = out + static_cast<size_t>(b) * row_bytes;
    uint8_t* sz_plane = o + nb;
    long n = counts[b];
    long k = 0;
    int prev = 0;
    auto put_nibble = [&](long idx, uint8_t v) {
      if (idx & 1) {
        o[idx >> 1] = static_cast<uint8_t>(o[idx >> 1] | (v << 4));
      } else {
        o[idx >> 1] = static_cast<uint8_t>(o[idx >> 1] | v);
      }
    };
    for (long i = 0; i < n; ++i) {
      int d = m[i] - prev;
      if (d < 0) return -2;
      int u = d / 15;              // 15-bp units carried by skips
      int frag_d = d - u * 15;     // 0..14
      while (u > 0) {
        int v = u > 15 ? 15 : u;   // skip record advances v*15
        if (k >= n_entries) return -1;
        put_nibble(k, static_cast<uint8_t>(v));  // size byte stays 0
        ++k;
        u -= v;
      }
      if (k >= n_entries) return -1;
      put_nibble(k, static_cast<uint8_t>(frag_d));
      int sz = s[i];
      sz_plane[k] = static_cast<uint8_t>(sz > 255 ? 255 : sz);
      ++k;
      prev = m[i];
    }
  }
  return 0;
}

// Fast %.{decimals}f for the common bedgraph value range (round 5: the
// per-line snprintf float conversion was ~the whole formatter cost,
// ~0.8 ms per chunk track at config-4 scale). Emits the IDENTICAL digit
// string snprintf would: both round the exact decimal expansion to
// `decimals` places half-to-even, and the double product v*10^d differs
// from the exact product by < 2.3e-8 for |v| < 1e3 (eps * 1e8), so
// whenever the scaled value sits further than 1e-6 from a rounding tie
// the integer-rounded product yields the same digits. Near-tie, big, or
// non-finite values return -1 and the caller falls back to snprintf.
static long format_fixed(char* dst, double v, int decimals) {
  static const double POW10[10] = {1,    1e1,  1e2, 1e3, 1e4,
                                   1e5,  1e6,  1e7, 1e8, 1e9};
  if (decimals < 0 || decimals > 9) return -1;
  const double av = v < 0 ? -v : v;
  if (!(av < 1e3)) return -1;  // also catches NaN/inf
  const double scaled = av * POW10[decimals];
  const double fl = __builtin_floor(scaled);
  const double frac = scaled - fl;
  if (frac > 0.5 - 1e-6 && frac < 0.5 + 1e-6) return -1;  // near tie
  long long iv = static_cast<long long>(fl) + (frac > 0.5 ? 1 : 0);
  long w = 0;
  if (__builtin_signbit(v)) dst[w++] = '-';
  const long long p = static_cast<long long>(POW10[decimals]);
  long long ip = iv / p;
  long long fp = iv % p;
  char tmp[24];
  int k = 0;
  do {
    tmp[k++] = static_cast<char>('0' + ip % 10);
    ip /= 10;
  } while (ip > 0);
  while (k > 0) dst[w++] = tmp[--k];
  if (decimals > 0) {
    dst[w++] = '.';
    for (int d = decimals - 1; d >= 0; --d) {
      dst[w + d] = static_cast<char>('0' + fp % 10);
      fp /= 10;
    }
    w += decimals;
  }
  return w;
}

// Bedgraph line formatter (round-4 writer batching): emits
// "<chrom>\t<start>\t<end>\t<value>\n" per interval into `out` and the
// byte offset of each line start into `offsets` (n+1 entries, the last
// one == total bytes). Value formatting replicates
// io/bedgraph.py::format_value exactly: %.<decimals>f, trailing zeros
// after the decimal point stripped, then a trailing '.', and -0 -> 0
// (glibc printf and CPython format both produce the correctly-rounded
// decimal expansion, so the digit strings agree; pinned by
// tests/test_io.py). Returns total bytes, or -1 if `cap` is too small.
long nucio_format_bedgraph(const char* chrom, const int64_t* starts,
                           const int64_t* ends, const double* vals, long n,
                           int decimals, char* out, long cap,
                           int64_t* offsets) {
  const long chrom_len = static_cast<long>(strlen(chrom));
  long w = 0;
  for (long i = 0; i < n; ++i) {
    offsets[i] = w;
    if (w + chrom_len + 96 > cap) return -1;
    memcpy(out + w, chrom, chrom_len);
    w += chrom_len;
    out[w++] = '\t';
    w += snprintf(out + w, 32, "%lld", static_cast<long long>(starts[i]));
    out[w++] = '\t';
    w += snprintf(out + w, 32, "%lld", static_cast<long long>(ends[i]));
    out[w++] = '\t';
    long vw = format_fixed(out + w, vals[i], decimals);
    if (vw < 0) vw = snprintf(out + w, 40, "%.*f", decimals, vals[i]);
    // snprintf returns the WOULD-BE length: a truncated value (|v| >=
    // ~1e34 or huge `decimals`) would otherwise advance `w` past
    // unwritten bytes and break the per-line 96-byte reserve checked at
    // loop entry. Fail cleanly like the cap check does.
    if (vw < 0 || vw >= 40) return -1;
    // strip trailing zeros after the '.', then a bare trailing '.'
    if (memchr(out + w, '.', vw) != nullptr) {
      while (vw > 0 && out[w + vw - 1] == '0') --vw;
      if (vw > 0 && out[w + vw - 1] == '.') --vw;
    }
    if (vw == 2 && out[w] == '-' && out[w + 1] == '0') {
      out[w] = '0';
      vw = 1;
    }
    w += vw;
    out[w++] = '\n';
  }
  offsets[n] = w;
  return w;
}

// Parse bedgraph text "chrom\tstart\tend\tvalue\n" from buf[0:len).
// Parses at most max_lines COMPLETE lines (a trailing partial line is
// left unconsumed for the caller's next block); returns the number of
// lines parsed, or -1 on malformed input. *consumed = bytes consumed.
// Chrom runs: breaks[k] = first line index of each run of equal chrom
// fields (always includes 0 when any line parses) and break_offs[k] =
// byte offset of that line (the caller reads the chrom name there);
// parsing stops early if the break table fills. Inverse of
// nucio_format_bedgraph; consumer: models/standalone.py ::
// SequentialOccTracks (the nfr stage's occ-track scan — a per-line
// Python parse of 3 genome-scale bedgraphs was 15% of the config-4
// wall, round-4 VERDICT weak #3).
long nucio_parse_bedgraph(const char* buf, long len, long max_lines,
                          int64_t* starts, int64_t* ends, double* vals,
                          long* breaks, long* break_offs, long max_breaks,
                          long* n_breaks, long* consumed) {
  long n = 0;
  long pos = 0;
  long nb = 0;
  const char* prev_chrom = nullptr;
  long prev_chrom_len = 0;
  while (n < max_lines && pos < len) {
    const char* nl = static_cast<const char*>(
        memchr(buf + pos, '\n', len - pos));
    if (nl == nullptr) break;  // partial line: wait for more bytes
    const char* p = buf + pos;
    const char* tab1 = static_cast<const char*>(memchr(p, '\t', nl - p));
    if (tab1 == nullptr) return -1;
    const long clen = tab1 - p;
    if (prev_chrom == nullptr || clen != prev_chrom_len ||
        memcmp(p, prev_chrom, clen) != 0) {
      if (nb >= max_breaks) break;  // caller resumes with a fresh call
      breaks[nb] = n;
      break_offs[nb] = pos;
      ++nb;
      prev_chrom = p;
      prev_chrom_len = clen;
    }
    char* q = nullptr;
    starts[n] = strtoll(tab1 + 1, &q, 10);
    if (q == nullptr || *q != '\t') return -1;
    ends[n] = strtoll(q + 1, &q, 10);
    if (q == nullptr || *q != '\t') return -1;
    vals[n] = strtod(q + 1, &q);
    // field 3 must end inside the line; anything after it (extra BED
    // columns — nucpos/occpeaks rows reuse this parser for re-indexing,
    // parallel/distributed.py :: rebuild_tabix) is accepted as-is
    if (q == nullptr || q > nl) return -1;
    ++n;
    pos = (nl - buf) + 1;
  }
  *n_breaks = nb;
  *consumed = pos;
  return n;
}

}  // extern "C"
