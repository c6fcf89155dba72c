// Zstandard frame decoder (RFC 8878) for the host, with a thread pool.
//
// The native counterpart of data/zstd.py, which stays the plain version:
// frames (one or several in a buffer, skippable frames passed over, a
// dictionary refused, the content checksum XXH64 checked), raw / RLE /
// compressed blocks, raw / RLE / Huffman literals in 1 or 4 streams (the
// weights direct or FSE-coded, or the previous block's tree), sequences
// under predefined / RLE / FSE / repeated tables and the three repeat
// offsets. Every read is bounded by its buffer; malformed input returns
// an error message, never reads or writes outside the buffers.
//
// zstd_decode_batch decodes a list of records on a pool of host threads,
// one record at a time per thread. A record's output goes into the
// caller's buffer of exact capacity, or, where the caller gives none, into
// one the library allocates (freed with zstd_free).
//
// host_crc32c checks the OCDBT files that hold the records.
//
// Built with the host compiler at first use: data/zstd_host.py.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ZstdError : std::runtime_error {
  explicit ZstdError(const std::string& m) : std::runtime_error(m) {}
};

[[noreturn]] void fail(const char* m) { throw ZstdError(m); }

const uint32_t MAGIC = 0xFD2FB528u;
const uint32_t SKIPPABLE = 0x184D2A50u;

// (baseline, extra bits) of each literal length and match length code
const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
// the predefined distributions
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

inline uint64_t load_le(const uint8_t* p, size_t avail) {
  // up to 8 bytes from p, zeros past avail
  uint64_t v = 0;
  if (avail >= 8) {
    std::memcpy(&v, p, 8);
  } else {
    for (size_t i = 0; i < avail; ++i) v |= uint64_t(p[i]) << (8 * i);
  }
  return v;
}

inline int bit_length(uint64_t x) { return x ? 64 - __builtin_clzll(x) : 0; }

// Little-endian bits from data[pos:end], low bits first (FSE table
// descriptions); bits past end read as zeros.
struct ForwardBits {
  const uint8_t* data;
  size_t start, end;
  uint64_t bit = 0;
  ForwardBits(const uint8_t* d, size_t s, size_t e) : data(d), start(s), end(e) {}
  uint32_t peek(int n) const {
    size_t b = start + (bit >> 3);
    uint64_t v = b < end ? load_le(data + b, end - b) : 0;
    return uint32_t((v >> (bit & 7)) & ((1ull << n) - 1));
  }
  uint32_t read(int n) {
    uint32_t v = peek(n);
    bit += n;
    return v;
  }
  size_t after() const { return start + (bit + 7) / 8; }
};

// A backward bitstream: read from its last byte's highest bit under the
// end marker towards its first byte; bits past the start read as zeros.
struct BackwardBits {
  const uint8_t* data;
  size_t size;
  int64_t pos;  // bits left
  BackwardBits(const uint8_t* d, size_t n) : data(d), size(n) {
    if (n == 0 || d[n - 1] == 0) fail("corrupt Zstandard bitstream: no end marker");
    pos = int64_t(n - 1) * 8 + bit_length(d[n - 1]) - 1;
  }
  inline uint64_t peek(int n) const {  // n <= 56
    int64_t p = pos - n;
    uint64_t v;
    if (p >= 0) {
      size_t b = size_t(p >> 3);
      v = load_le(data + b, size - b) >> (p & 7);
    } else {
      v = load_le(data, size) << (-p);
    }
    return n ? v & ((1ull << n) - 1) : 0;
  }
  inline uint64_t read(int n) {
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }
};

// ---------------------------------------------------------------- FSE

struct Dist {
  int log = 0;
  std::vector<int> counts;
};

size_t read_distribution(const uint8_t* data, size_t pos, size_t end, int max_symbol, int max_log,
                         Dist& dist) {
  ForwardBits bits(data, pos, end);
  int log = int(bits.read(4)) + 5;
  if (log > max_log) fail("corrupt Zstandard data: FSE accuracy log too large");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  std::vector<int>& counts = dist.counts;
  counts.clear();
  while (remaining > 1 && int(counts.size()) <= max_symbol) {
    int hi = 2 * threshold - 1 - remaining;
    int low = int(bits.peek(nbits - 1));
    int value;
    if ((low & (threshold - 1)) < hi) {
      value = low & (threshold - 1);
      bits.bit += nbits - 1;
    } else {
      value = int(bits.peek(nbits)) & (2 * threshold - 1);
      if (value >= threshold) value -= hi;
      bits.bit += nbits;
    }
    int count = value - 1;
    remaining -= count < 0 ? -count : count;
    counts.push_back(count);
    if (count == 0) {  // runs of zero counts: 2-bit repeat flags, 3 continues
      while (true) {
        int flag = int(bits.read(2));
        for (int i = 0; i < flag; ++i) counts.push_back(0);
        if (int(counts.size()) > max_symbol + 1) fail("corrupt Zstandard data: bad FSE distribution");
        if (flag != 3) break;
      }
    }
    while (remaining < threshold) {
      nbits -= 1;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || int(counts.size()) > max_symbol + 1)
    fail("corrupt Zstandard data: bad FSE distribution");
  dist.log = log;
  size_t after = bits.after();
  if (after > end) fail("corrupt Zstandard data: FSE distribution past its block");
  return after;
}

struct FseTable {
  int log = 0;
  std::vector<uint16_t> symbol;
  std::vector<uint8_t> nbits;
  std::vector<uint32_t> base;
  bool ready = false;
};

void build_fse(const Dist& dist, FseTable& t) {
  int log = dist.log, size = 1 << log;
  t.log = log;
  t.symbol.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  int high = size - 1;
  const std::vector<int>& counts = dist.counts;
  for (size_t s = 0; s < counts.size(); ++s) {  // "less than 1" symbols take the top cells
    if (counts[s] == -1) {
      if (high < 0) fail("corrupt Zstandard data: FSE table does not fill");
      t.symbol[high--] = uint16_t(s);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (size_t s = 0; s < counts.size(); ++s) {
    for (int k = 0; k < counts[s]; ++k) {
      t.symbol[pos] = uint16_t(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) fail("corrupt Zstandard data: FSE table does not fill");
  std::vector<uint32_t> nxt(counts.size());
  for (size_t s = 0; s < counts.size(); ++s) nxt[s] = counts[s] == -1 ? 1 : uint32_t(counts[s]);
  for (int u = 0; u < size; ++u) {
    int s = t.symbol[u];
    uint32_t x = nxt[s]++;
    int nb = log - (bit_length(x) - 1);
    t.nbits[u] = uint8_t(nb);
    t.base[u] = (x << nb) - uint32_t(size);
  }
  t.ready = true;
}

void rle_fse(int symbol, FseTable& t) {
  t.log = 0;
  t.symbol.assign(1, uint16_t(symbol));
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
  t.ready = true;
}

void default_fse(const int16_t* counts, int n, int log, FseTable& t) {
  Dist d;
  d.log = log;
  d.counts.assign(counts, counts + n);
  build_fse(d, t);
}

struct Fse {
  const FseTable* t;
  uint32_t state;
  Fse(const FseTable& table, BackwardBits& bits) : t(&table) {
    state = uint32_t(bits.read(table.log));
  }
  inline int peek() const { return t->symbol[state]; }
  inline void update(BackwardBits& bits) {
    state = t->base[state] + uint32_t(bits.read(t->nbits[state]));
    if (state >= t->symbol.size()) fail("corrupt Zstandard data: FSE state out of its table");
  }
};

// ---------------------------------------------------------------- Huffman

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> symbol, length;
  bool ready = false;
};

size_t huffman_weights(const uint8_t* data, size_t pos, size_t end, std::vector<int>& weights) {
  if (pos >= end) fail("corrupt Zstandard data: truncated Huffman tree");
  int header = data[pos++];
  weights.clear();
  if (header >= 128) {  // direct: 4 bits a weight
    int n = header - 127;
    size_t nb = size_t(n + 1) / 2;
    if (pos + nb > end) fail("corrupt Zstandard data: truncated Huffman tree");
    for (int i = 0; i < n; ++i) {
      uint8_t b = data[pos + i / 2];
      weights.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
    pos += nb;
  } else {  // FSE-coded, two interleaved states
    size_t stop = pos + size_t(header);
    if (stop > end) fail("corrupt Zstandard data: truncated Huffman tree");
    Dist dist;
    size_t start = read_distribution(data, pos, stop, 255, 6, dist);
    FseTable table;
    build_fse(dist, table);
    BackwardBits bits(data + start, stop - start);
    Fse states[2] = {Fse(table, bits), Fse(table, bits)};
    int i = 0;
    while (true) {
      weights.push_back(states[i].peek());
      states[i].update(bits);
      if (bits.pos < 0) {
        weights.push_back(states[1 - i].peek());
        break;
      }
      if (weights.size() > 255) fail("corrupt Zstandard data: too many Huffman weights");
      i = 1 - i;
    }
    pos = stop;
  }
  uint64_t total = 0;
  for (int w : weights) {
    if (w > 11) fail("corrupt Zstandard data: Huffman weight too large");
    if (w) total += uint64_t(1) << (w - 1);
  }
  if (!total) fail("corrupt Zstandard data: empty Huffman tree");
  int max_bits = bit_length(total);
  uint64_t rest = (uint64_t(1) << max_bits) - total;
  if (rest & (rest - 1)) fail("corrupt Zstandard data: Huffman weights do not complete a tree");
  if (weights.size() > 255) fail("corrupt Zstandard data: too many Huffman weights");
  weights.push_back(bit_length(rest));
  return pos;
}

void huffman_table(const std::vector<int>& weights, Huffman& h) {
  uint64_t total = 0;
  for (int w : weights)
    if (w) total += uint64_t(1) << (w - 1);
  int max_bits = bit_length(total) - 1;
  if (max_bits > 11) fail("corrupt Zstandard data: Huffman code too long");
  h.max_bits = max_bits;
  h.symbol.assign(size_t(1) << max_bits, 0);
  h.length.assign(size_t(1) << max_bits, 0);
  size_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (size_t s = 0; s < weights.size(); ++s) {
      if (weights[s] == w) {
        size_t n = size_t(1) << (w - 1);
        std::memset(&h.symbol[pos], int(s), n);
        std::memset(&h.length[pos], max_bits + 1 - w, n);
        pos += n;
      }
    }
  }
  h.ready = true;
}

void huffman_stream(const uint8_t* stream, size_t size, const Huffman& h, uint8_t* out, size_t n) {
  BackwardBits bits(stream, size);
  const int mb = h.max_bits;
  const uint8_t* sym = h.symbol.data();
  const uint8_t* len = h.length.data();
  const uint64_t mask = (uint64_t(1) << mb) - 1;
  size_t i = 0;
  // four codes (at most 44 bits) from one 8-byte load that ends at the
  // byte holding the next bit, while 64 bits remain below it
  while (i + 4 <= n && bits.pos >= 64) {
    size_t end = size_t(bits.pos + 7) >> 3;
    uint64_t w;
    std::memcpy(&w, stream + end - 8, 8);
    int64_t base = int64_t(end - 8) * 8;  // the stream bit of w's bit 0
    for (int k = 0; k < 4; ++k) {
      uint32_t v = uint32_t((w >> (bits.pos - base - mb)) & mask);
      out[i++] = sym[v];
      bits.pos -= len[v];
    }
  }
  for (; i < n; ++i) {
    uint32_t v = uint32_t(bits.peek(mb));
    out[i] = sym[v];
    bits.pos -= len[v];
  }
  if (bits.pos != 0) fail("corrupt Zstandard data: Huffman stream not consumed exactly");
}

// ---------------------------------------------------------------- blocks

struct Output {
  uint8_t* buf;
  size_t cap, len;
  bool grow;
  void reserve(size_t more) {
    if (len + more <= cap) return;
    if (!grow) fail("corrupt Zstandard data: more content than the record's size");
    size_t want = cap ? cap : 4096;
    while (want < len + more) want *= 2;
    uint8_t* nb = static_cast<uint8_t*>(std::realloc(buf, want));
    if (!nb) fail("out of host memory");
    buf = nb;
    cap = want;
  }
};

struct Frame {
  size_t start;  // this frame's first byte in the output
  Huffman huffman;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;
  std::vector<int> weights;
};

// the literals section at data[0:size]: fills frame.literals, returns the
// position after it
size_t literals_section(const uint8_t* data, size_t size, Frame& frame) {
  if (size < 1) fail("corrupt Zstandard data: truncated literals");
  int kind = data[0] & 3, fmt = (data[0] >> 2) & 3;
  size_t pos;
  if (kind == 0 || kind == 1) {  // raw, RLE
    size_t n;
    if (fmt == 0 || fmt == 2) {
      n = data[0] >> 3;
      pos = 1;
    } else if (fmt == 1) {
      if (size < 2) fail("corrupt Zstandard data: truncated literals");
      n = (data[0] >> 4) + (size_t(data[1]) << 4);
      pos = 2;
    } else {
      if (size < 3) fail("corrupt Zstandard data: truncated literals");
      n = (data[0] >> 4) + (size_t(data[1]) << 4) + (size_t(data[2]) << 12);
      pos = 3;
    }
    if (kind == 0) {
      if (pos + n > size) fail("corrupt Zstandard data: truncated literals");
      frame.literals.assign(data + pos, data + pos + n);
      return pos + n;
    }
    if (pos + 1 > size) fail("corrupt Zstandard data: truncated literals");
    frame.literals.assign(n, data[pos]);
    return pos + 1;
  }
  static const int NBYTES[4] = {3, 3, 4, 5}, WIDTH[4] = {10, 10, 14, 18};
  int nbytes = NBYTES[fmt], width = WIDTH[fmt];
  if (size_t(nbytes) > size) fail("corrupt Zstandard data: truncated literals");
  uint64_t header = load_le(data, nbytes) & ((uint64_t(1) << (8 * nbytes)) - 1);
  header >>= 4;
  size_t regen = header & ((uint64_t(1) << width) - 1), comp = header >> width;
  pos = nbytes;
  size_t end = pos + comp;
  if (end > size) fail("corrupt Zstandard data: truncated literals");
  if (kind == 2) {
    pos = huffman_weights(data, pos, end, frame.weights);
    huffman_table(frame.weights, frame.huffman);
  } else if (!frame.huffman.ready) {
    fail("corrupt Zstandard data: treeless literals with no tree");
  }
  frame.literals.resize(regen);
  if (fmt == 0) {
    huffman_stream(data + pos, end - pos, frame.huffman, frame.literals.data(), regen);
    return end;
  }
  if (pos + 6 > end) fail("corrupt Zstandard data: truncated literals");
  size_t sizes[4];
  for (int k = 0; k < 3; ++k) sizes[k] = data[pos + 2 * k] | (size_t(data[pos + 2 * k + 1]) << 8);
  pos += 6;
  if (sizes[0] + sizes[1] + sizes[2] > end - pos) fail("corrupt Zstandard data: bad stream sizes");
  sizes[3] = end - pos - sizes[0] - sizes[1] - sizes[2];
  size_t each = (regen + 3) / 4;
  if (3 * each > regen) fail("corrupt Zstandard data: too few literals for four streams");
  size_t at = 0;
  for (int k = 0; k < 4; ++k) {
    size_t n = k < 3 ? each : regen - 3 * each;
    huffman_stream(data + pos, sizes[k], frame.huffman, frame.literals.data() + at, n);
    pos += sizes[k];
    at += n;
  }
  return end;
}

size_t sequence_tables(const uint8_t* data, size_t pos, size_t size, Frame& frame) {
  if (pos >= size) fail("corrupt Zstandard data: truncated sequences");
  int modes = data[pos++];
  struct Spec {
    FseTable* t;
    int shift;
    const int16_t* def;
    int n_def, log_def, max_symbol, max_log;
  } specs[3] = {{&frame.ll, 6, LL_DEFAULT, 36, 6, 35, 9},
                {&frame.of, 4, OF_DEFAULT, 29, 5, 31, 8},
                {&frame.ml, 2, ML_DEFAULT, 53, 6, 52, 9}};
  for (const Spec& s : specs) {
    int mode = (modes >> s.shift) & 3;
    if (mode == 0) {
      default_fse(s.def, s.n_def, s.log_def, *s.t);
    } else if (mode == 1) {
      if (pos >= size) fail("corrupt Zstandard data: truncated sequences");
      rle_fse(data[pos++], *s.t);
    } else if (mode == 2) {
      Dist d;
      pos = read_distribution(data, pos, size, s.max_symbol, s.max_log, d);
      build_fse(d, *s.t);
    } else if (!s.t->ready) {
      fail("corrupt Zstandard data: repeated table with none");
    }
  }
  return pos;
}

void compressed_block(const uint8_t* data, size_t size, Frame& frame, Output& out) {
  size_t pos = literals_section(data, size, frame);
  if (pos >= size) fail("corrupt Zstandard data: truncated sequences");
  size_t n = data[pos];
  if (n < 128) {
    pos += 1;
  } else if (n < 255) {
    if (pos + 2 > size) fail("corrupt Zstandard data: truncated sequences");
    n = ((n - 128) << 8) + data[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > size) fail("corrupt Zstandard data: truncated sequences");
    n = data[pos + 1] + (size_t(data[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  const uint8_t* lits = frame.literals.data();
  const size_t nlit = frame.literals.size();
  size_t lit = 0;
  if (n) {
    pos = sequence_tables(data, pos, size, frame);
    BackwardBits bits(data + pos, size - pos);
    Fse ll(frame.ll, bits), of(frame.of, bits), ml(frame.ml, bits);
    uint64_t* rep = frame.rep;
    for (size_t i = 0; i < n; ++i) {
      int of_code = of.peek(), ml_code = ml.peek(), ll_code = ll.peek();
      if (of_code > 31 || ml_code > 52 || ll_code > 35) fail("corrupt Zstandard data: bad code");
      uint64_t offset = (uint64_t(1) << of_code) + bits.read(of_code);
      uint64_t match = ML_BASE[ml_code] + bits.read(ML_BITS[ml_code]);
      uint64_t length = LL_BASE[ll_code] + bits.read(LL_BITS[ll_code]);
      if (offset > 3) {
        offset -= 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        // a sequence without literals shifts the choice by one
        uint64_t idx = offset - 1 + (length == 0);
        if (idx == 1) {
          std::swap(rep[0], rep[1]);
        } else if (idx == 2) {
          uint64_t r2 = rep[2];
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = r2;
        } else if (idx == 3) {  // libzstd turns a 0 into 1
          uint64_t r0 = rep[0] > 1 ? rep[0] - 1 : 1;
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = r0;
        }
        offset = rep[0];
      }
      if (length > nlit - lit) fail("corrupt Zstandard data: sequences past the literals");
      out.reserve(length + match);
      std::memcpy(out.buf + out.len, lits + lit, length);
      out.len += length;
      lit += length;
      size_t produced = out.len - frame.start;
      if (offset > produced || offset == 0) fail("corrupt Zstandard data: match before the start");
      uint8_t* dst = out.buf + out.len;
      const uint8_t* src = dst - offset;
      if (offset >= match) {
        std::memcpy(dst, src, match);
      } else {  // overlapping: the period repeats
        for (uint64_t k = 0; k < match; ++k) dst[k] = src[k];
      }
      out.len += match;
      if (i < n - 1) {
        ll.update(bits);
        ml.update(bits);
        of.update(bits);
      }
    }
    if (bits.pos != 0) fail("corrupt Zstandard data: sequences not consumed exactly");
  }
  out.reserve(nlit - lit);
  std::memcpy(out.buf + out.len, lits + lit, nlit - lit);
  out.len += nlit - lit;
}

// ---------------------------------------------------------------- frames

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint64_t p1 = 11400714785074694791ull, p2 = 14029467366897019727ull,
                 p3 = 1609587929392839161ull, p4 = 9650029242287828579ull,
                 p5 = 2870177450012600261ull;
  auto rnd = [&](uint64_t acc, uint64_t lane) { return rotl(acc + lane * p2, 31) * p1; };
  size_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {p1 + p2, p2, 0, 0 - p1};
    for (; i + 32 <= n; i += 32)
      for (int k = 0; k < 4; ++k) v[k] = rnd(v[k], load_le(p + i + 8 * k, 8));
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
    for (int k = 0; k < 4; ++k) h = (h ^ rnd(0, v[k])) * p1 + p4;
  } else {
    h = p5;
  }
  h += n;
  for (; i + 8 <= n; i += 8) h = rotl(h ^ rnd(0, load_le(p + i, 8)), 27) * p1 + p4;
  if (i + 4 <= n) {
    uint32_t w;
    std::memcpy(&w, p + i, 4);
    h = rotl(h ^ (uint64_t(w) * p1), 23) * p2 + p3;
    i += 4;
  }
  for (; i < n; ++i) h = rotl(h ^ (p[i] * p5), 11) * p1;
  h = (h ^ (h >> 33)) * p2;
  h = (h ^ (h >> 29)) * p3;
  return h ^ (h >> 32);
}

size_t decode_frame(const uint8_t* data, size_t size, size_t pos, Output& out) {
  if (pos + 5 > size) fail("truncated Zstandard frame");
  int desc = data[pos + 4];
  int fcs_flag = desc >> 6, single = (desc >> 5) & 1, checksum = (desc >> 2) & 1,
      dict_flag = desc & 3;
  if (desc & 8) fail("corrupt Zstandard data: reserved frame header bit set");
  pos += 5 + (single ? 0 : 1);
  static const int DICT[4] = {0, 1, 2, 4};
  int dict_size = DICT[dict_flag];
  if (pos + dict_size > size) fail("truncated Zstandard frame");
  if (dict_size && load_le(data + pos, dict_size) & ((uint64_t(1) << (8 * dict_size)) - 1))
    fail("a Zstandard frame that needs a dictionary is not read");
  pos += dict_size;
  static const int FCS[4] = {0, 2, 4, 8};
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : FCS[fcs_flag];
  bool has_content = fcs_size > 0;
  uint64_t content = 0;
  if (pos + fcs_size > size) fail("truncated Zstandard frame");
  if (fcs_size) {
    content = fcs_size == 8 ? load_le(data + pos, 8)
                            : load_le(data + pos, fcs_size) & ((uint64_t(1) << (8 * fcs_size)) - 1);
    if (fcs_size == 2) content += 256;
  }
  pos += fcs_size;
  if (has_content) out.reserve(content);
  Frame frame;
  frame.start = out.len;
  while (true) {
    if (pos + 3 > size) fail("truncated Zstandard frame");
    uint32_t head = data[pos] | (uint32_t(data[pos + 1]) << 8) | (uint32_t(data[pos + 2]) << 16);
    int last = head & 1, kind = (head >> 1) & 3;
    size_t bsize = head >> 3;
    pos += 3;
    if (kind == 0) {
      if (pos + bsize > size) fail("truncated Zstandard frame");
      out.reserve(bsize);
      std::memcpy(out.buf + out.len, data + pos, bsize);
      out.len += bsize;
      pos += bsize;
    } else if (kind == 1) {
      if (pos + 1 > size) fail("truncated Zstandard frame");
      out.reserve(bsize);
      std::memset(out.buf + out.len, data[pos], bsize);
      out.len += bsize;
      pos += 1;
    } else if (kind == 2) {
      if (pos + bsize > size) fail("truncated Zstandard frame");
      compressed_block(data + pos, bsize, frame, out);
      pos += bsize;
    } else {
      fail("corrupt Zstandard data: reserved block type");
    }
    if (last) break;
  }
  size_t produced = out.len - frame.start;
  if (has_content && content != produced)
    fail("corrupt Zstandard frame: its size differs from its header's");
  if (checksum) {
    if (pos + 4 > size) fail("truncated Zstandard frame");
    uint32_t want = uint32_t(load_le(data + pos, 4));
    if (uint32_t(xxh64(out.buf + frame.start, produced)) != want)
      fail("corrupt Zstandard frame: content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decode_all(const uint8_t* data, size_t size, Output& out) {
  size_t pos = 0;
  while (pos < size) {
    if (pos + 4 > size) fail("truncated Zstandard data");
    uint32_t magic = uint32_t(load_le(data + pos, 4));
    if ((magic & 0xFFFFFFF0u) == SKIPPABLE) {
      if (pos + 8 > size) fail("truncated Zstandard data");
      size_t skip = uint32_t(load_le(data + pos + 4, 4));
      if (skip > size - pos - 8) fail("truncated Zstandard skippable frame");
      pos += 8 + skip;
    } else if (magic == MAGIC) {
      pos = decode_frame(data, size, pos, out);
    } else {
      fail("not Zstandard data (bad magic number)");
    }
  }
}

}  // namespace

extern "C" {

// Decode `count` records on `threads` host threads: record i is
// src[i][0:src_len[i]]. Its content goes into dst[i], which it must fill
// exactly (dst_cap[i] bytes), or, where dst[i] is null, into a buffer the
// library allocates and returns in owned[i]. out_len[i] gets the content's
// length and errors[i * err_len:] a message ("" when the record decoded).
// Returns the number of records that failed.
int zstd_decode_batch(int64_t count, const uint8_t* const* src, const int64_t* src_len,
                      uint8_t* const* dst, const int64_t* dst_cap, int64_t* out_len,
                      uint8_t** owned, int threads, char* errors, int64_t err_len) {
  std::atomic<int64_t> next{0};
  std::atomic<int> failed{0};
  auto work = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= count) return;
      Output out{dst[i], dst[i] ? size_t(dst_cap[i]) : 0, 0, dst[i] == nullptr};
      std::string err;
      try {
        decode_all(src[i], size_t(src_len[i]), out);
        if (dst[i] && out.len != out.cap)
          fail("corrupt Zstandard data: less content than the record's size");
      } catch (const std::exception& e) {
        err = e.what();
      }
      out_len[i] = int64_t(out.len);
      if (!dst[i]) owned[i] = out.buf;
      if (!err.empty()) {
        failed.fetch_add(1);
        size_t n = std::min(err.size(), size_t(err_len - 1));
        std::memcpy(errors + i * err_len, err.data(), n);
        errors[i * err_len + n] = 0;
      } else {
        errors[i * err_len] = 0;
      }
    }
  };
  int n = threads < 1 ? 1 : threads;
  if (n > count) n = int(count);
  std::vector<std::thread> pool;
  for (int t = 1; t < n; ++t) pool.emplace_back(work);
  work();
  for (std::thread& t : pool) t.join();
  return failed.load();
}

void zstd_free(uint8_t* p) { std::free(p); }

uint64_t zstd_xxh64(const uint8_t* p, int64_t n) { return xxh64(p, size_t(n)); }

// CRC-32C (Castagnoli), the checksum that ends every OCDBT file
// (train/orbax.py).
uint32_t host_crc32c(const uint8_t* p, int64_t n) {
  static uint32_t table[256];
  static std::atomic<bool> ready{false};
  if (!ready.load(std::memory_order_acquire)) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      table[i] = c;
    }
    ready.store(true, std::memory_order_release);
  }
  uint32_t crc = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
