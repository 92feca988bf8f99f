// Native host data path of the port: the TSV parser, the expanding-history
// line generator of the ETL, and a CSV column reader for raw logs.
//
// The first two are copies of clsr_tpu/native/fastparse.cpp, kept here so
// that the port imports and builds nothing of the JAX package.  The parser
// reads the 8-column TSV (label \t user \t item \t cate \t ts \t item_hist \t
// cate_hist \t ts_hist) and computes the three log-scaled time features
// with the semantics of the reference's sequential_iterator.py:119-150
// (delta / time_range, floored at 0.5, natural log).  Vocab lookup maps
// unknown tokens to 0 (sequential_iterator.py:105-107).
//
// Plain C ABI, bound with ctypes by clsr_tpu_torch/native/__init__.py;
// results are filled into caller-allocated numpy buffers in a second pass
// after size discovery.  Built by clsr_tpu_torch/ops/_build.py with
// g++ -O3 -std=c++17 -shared -fPIC into clsr_tpu_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::string blob;  // owns key storage
  std::unordered_map<std::string_view, int32_t> map;
};

struct ParseResult {
  std::vector<float> labels;
  std::vector<int32_t> users, items, cates;
  std::vector<double> times;
  std::vector<int64_t> offsets;  // n+1
  std::vector<int32_t> hist_items, hist_cates;
  std::vector<float> td, tff, ttn;
};

inline int32_t lookup(const Vocab* v, std::string_view key) {
  auto it = v->map.find(key);
  return it == v->map.end() ? 0 : it->second;
}

// split [begin, end) on sep, invoking fn(token) per token
template <typename Fn>
inline void for_each_token(const char* begin, const char* end, char sep,
                           Fn&& fn) {
  const char* p = begin;
  while (p <= end) {
    const char* q = static_cast<const char*>(
        memchr(p, sep, static_cast<size_t>(end - p)));
    if (q == nullptr) q = end;
    fn(std::string_view(p, static_cast<size_t>(q - p)));
    if (q == end) break;
    p = q + 1;
  }
}

}  // namespace

extern "C" {

// keys_blob: '\n'-joined keys; ids parallel array of length n.
void* clsr_vocab_new(const char* keys_blob, int64_t blob_len,
                     const int32_t* ids, int64_t n) {
  auto* v = new Vocab();
  v->blob.assign(keys_blob, static_cast<size_t>(blob_len));
  v->map.reserve(static_cast<size_t>(n) * 2);
  const char* p = v->blob.data();
  const char* end = p + v->blob.size();
  int64_t i = 0;
  while (p <= end && i < n) {
    const char* q = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (q == nullptr) q = end;
    v->map.emplace(std::string_view(p, static_cast<size_t>(q - p)),
                   ids[i++]);
    if (q == end) break;
    p = q + 1;
  }
  return v;
}

void clsr_vocab_free(void* v) { delete static_cast<Vocab*>(v); }

void* clsr_parse_file(const char* path, void* user_v, void* item_v,
                      void* cate_v, double time_range) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && fread(buf.data(), 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  const Vocab* uv = static_cast<Vocab*>(user_v);
  const Vocab* iv = static_cast<Vocab*>(item_v);
  const Vocab* cv = static_cast<Vocab*>(cate_v);

  auto* r = new ParseResult();
  r->offsets.push_back(0);

  std::vector<double> ts_hist;
  const char* p = buf.data();
  const char* file_end = p + buf.size();

  while (p < file_end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(file_end - p)));
    if (line_end == nullptr) line_end = file_end;
    const char* line = p;
    p = line_end + 1;
    // strip \r and skip blank lines
    while (line_end > line && (line_end[-1] == '\r')) --line_end;
    if (line_end == line) continue;

    // split into 8 columns
    const char* cols[8];
    const char* col_end[8];
    int ncols = 0;
    const char* cp = line;
    while (ncols < 8) {
      const char* tab = static_cast<const char*>(
          memchr(cp, '\t', static_cast<size_t>(line_end - cp)));
      cols[ncols] = cp;
      col_end[ncols] = tab ? tab : line_end;
      ++ncols;
      if (!tab) break;
      cp = tab + 1;
    }
    if (ncols < 8) continue;

    r->labels.push_back(
        static_cast<float>(strtol(cols[0], nullptr, 10)));
    r->users.push_back(lookup(
        uv, std::string_view(cols[1],
                             static_cast<size_t>(col_end[1] - cols[1]))));
    r->items.push_back(lookup(
        iv, std::string_view(cols[2],
                             static_cast<size_t>(col_end[2] - cols[2]))));
    r->cates.push_back(lookup(
        cv, std::string_view(cols[3],
                             static_cast<size_t>(col_end[3] - cols[3]))));
    const double cur = strtod(cols[4], nullptr);
    r->times.push_back(cur);

    for_each_token(cols[5], col_end[5], ',', [&](std::string_view tok) {
      r->hist_items.push_back(lookup(iv, tok));
    });
    for_each_token(cols[6], col_end[6], ',', [&](std::string_view tok) {
      r->hist_cates.push_back(lookup(cv, tok));
    });
    ts_hist.clear();
    for_each_token(cols[7], col_end[7], ',', [&](std::string_view tok) {
      // strtod needs a NUL or stops at non-numeric — ',' and '\t' qualify
      ts_hist.push_back(strtod(tok.data(), nullptr));
    });

    const size_t n = ts_hist.size();
    // time features — verbatim sequential_iterator.py:119-150
    for (size_t i = 0; i + 1 < n; ++i) {
      double d = (ts_hist[i + 1] - ts_hist[i]) / time_range;
      r->td.push_back(static_cast<float>(std::log(std::max(d, 0.5))));
    }
    {
      double d = (cur - ts_hist[n - 1]) / time_range;
      r->td.push_back(static_cast<float>(std::log(std::max(d, 0.5))));
    }
    const double first = ts_hist[0];
    for (size_t i = 1; i < n; ++i) {
      double d = (ts_hist[i] - first) / time_range;
      r->tff.push_back(static_cast<float>(std::log(std::max(d, 0.5))));
    }
    {
      double d = (cur - first) / time_range;
      r->tff.push_back(static_cast<float>(std::log(std::max(d, 0.5))));
    }
    for (size_t i = 0; i < n; ++i) {
      double d = (cur - ts_hist[i]) / time_range;
      r->ttn.push_back(static_cast<float>(std::log(std::max(d, 0.5))));
    }
    r->offsets.push_back(static_cast<int64_t>(r->hist_items.size()));
  }
  return r;
}

int64_t clsr_result_n(void* rp) {
  return static_cast<int64_t>(static_cast<ParseResult*>(rp)->labels.size());
}

int64_t clsr_result_total(void* rp) {
  return static_cast<int64_t>(
      static_cast<ParseResult*>(rp)->hist_items.size());
}

void clsr_result_fill(void* rp, float* labels, int32_t* users,
                      int32_t* items, int32_t* cates, double* times,
                      int64_t* offsets, int32_t* hist_items,
                      int32_t* hist_cates, float* td, float* tff,
                      float* ttn) {
  auto* r = static_cast<ParseResult*>(rp);
  auto cp = [](auto& vec, auto* dst) {
    memcpy(dst, vec.data(), vec.size() * sizeof(vec[0]));
  };
  cp(r->labels, labels);
  cp(r->users, users);
  cp(r->items, items);
  cp(r->cates, cates);
  cp(r->times, times);
  cp(r->offsets, offsets);
  cp(r->hist_items, hist_items);
  cp(r->hist_cates, hist_cates);
  cp(r->td, td);
  cp(r->tff, tff);
  cp(r->ttn, ttn);
}

void clsr_result_free(void* rp) { delete static_cast<ParseResult*>(rp); }

// ---------------------------------------------------------------------------
// Expanding-history line generation (reference: sequential_reviews.py:358-438;
// Python counterpart: clsr_tpu_torch/data/etl.py generate_expanding), a copy
// of clsr_tpu/native/fastparse.cpp clsr_expand_lines.
//
// For numeric-id datasets the whole per-user loop (incremental prefix
// strings, per-line subsampling, buffered file writes) runs here.  The
// subsample rng is mt19937_64 (one uniform per candidate line whose split
// has frac < 1, in stream order): the kept-line SET differs from the numpy
// path for a given seed, the distribution is the same; the train split
// (frac 1.0) is byte-identical.  The same seed gives the JAX package's
// native engine's files byte for byte.
//
// Returns the number of lines written, or -1 on I/O error.
int64_t clsr_expand_lines(const int64_t* users, const int64_t* items,
                          const int64_t* cates, const int64_t* times,
                          const int8_t* split_idx, const int64_t* offsets,
                          int64_t n_groups, const double* subsample,
                          int64_t min_sequence, uint64_t seed,
                          const char* train_path, const char* valid_path,
                          const char* test_path) {
  FILE* outs[3] = {fopen(train_path, "w"), fopen(valid_path, "w"),
                   fopen(test_path, "w")};
  for (FILE* f : outs) {
    if (!f) {
      for (FILE* g : outs)
        if (g) fclose(g);
      return -1;
    }
  }
  std::vector<char> bufs[3];
  for (auto& b : bufs) b.resize(1 << 20);
  for (int s = 0; s < 3; ++s)
    setvbuf(outs[s], bufs[s].data(), _IOFBF, bufs[s].size());

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);

  std::string ih, ch, th, line;
  char tmp[32];
  auto append_int = [&tmp](std::string& dst, int64_t v) {
    int len = snprintf(tmp, sizeof(tmp), "%lld", (long long)v);
    dst.append(tmp, len);
  };

  int64_t written = 0;
  for (int64_t g = 0; g < n_groups; ++g) {
    int64_t lo = offsets[g], hi = offsets[g + 1];
    if (hi <= lo) continue;
    ih.clear(); ch.clear(); th.clear();
    append_int(ih, items[lo]);
    append_int(ch, cates[lo]);
    append_int(th, times[lo]);
    for (int64_t k = lo + 1; k < hi; ++k) {
      int s = split_idx[k];
      double frac = subsample[s];
      bool keep = true;
      if (frac < 1.0) keep = uni(rng) < frac;
      if (keep && (k - lo) >= min_sequence) {
        line.clear();
        line += "1\t";
        append_int(line, users[lo]);
        line += '\t';
        append_int(line, items[k]);
        line += '\t';
        append_int(line, cates[k]);
        line += '\t';
        append_int(line, times[k]);
        line += '\t';
        line += ih; line += '\t';
        line += ch; line += '\t';
        line += th; line += '\n';
        fwrite(line.data(), 1, line.size(), outs[s]);
        ++written;
      }
      if (k < hi - 1) {
        ih += ','; append_int(ih, items[k]);
        ch += ','; append_int(ch, cates[k]);
        th += ','; append_int(th, times[k]);
      }
    }
  }
  int64_t rc = written;
  for (FILE* f : outs)
    if (fclose(f) != 0) rc = -1;
  return rc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CSV column reader of raw interaction logs (the ETL's read; Python
// counterpart and fallback: clsr_tpu_torch/data/etl.py read_csv).
//
// One pass over the file after `skip_lines` lines (a header).  `kinds`
// holds one character a column: 'i' parses the field as a decimal int64
// (an optional sign, then digits), 's' interns it as a string (a code a
// row, the distinct strings in first-seen order), '-' skips it.  Blank
// lines are skipped and a trailing '\r' is dropped, as pd.read_csv does.
// The status says what the reader could not take, and the caller then
// reads the column as strings (NOT_INT) or the file by Python's csv
// module (QUOTE, FIELDS: a quoted field, or a row with another number of
// fields than `kinds` has).
namespace {

enum CsvStatus : int64_t { CSV_OK = 0, CSV_NOT_INT = 1, CSV_QUOTE = 2,
                           CSV_FIELDS = 3 };

struct CsvResult {
  int64_t status = CSV_OK;
  int64_t bad_col = -1, bad_row = -1, n_rows = 0;
  std::string data;  // the file; interned strings point into it
  std::vector<std::vector<int64_t>> ints;
  std::vector<std::vector<int32_t>> codes;
  std::vector<std::vector<std::string_view>> strings;
  std::vector<std::unordered_map<std::string_view, int32_t>> intern;
};

inline bool parse_int64(const char* p, const char* e, int64_t* out) {
  bool neg = false;
  if (p < e && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  if (p == e || e - p > 18) return false;
  int64_t v = 0;
  for (; p < e; ++p) {
    unsigned d = static_cast<unsigned>(*p - '0');
    if (d > 9) return false;
    v = v * 10 + d;
  }
  *out = neg ? -v : v;
  return true;
}

}  // namespace

extern "C" {

void* clsr_csv_read(const char* path, const char* kinds, int64_t n_cols,
                    int64_t skip_lines) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new CsvResult();
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  r->data.resize(size > 0 ? static_cast<size_t>(size) : 0);
  if (size > 0 && fread(&r->data[0], 1, r->data.size(), f) != r->data.size()) {
    fclose(f);
    delete r;
    return nullptr;
  }
  fclose(f);
  r->ints.resize(n_cols);
  r->codes.resize(n_cols);
  r->strings.resize(n_cols);
  r->intern.resize(n_cols);
  if (memchr(r->data.data(), '"', r->data.size())) {
    r->status = CSV_QUOTE;
    return r;
  }
  size_t est = r->data.size() / 16 + 1;
  for (int64_t c = 0; c < n_cols; ++c) {
    if (kinds[c] == 'i') r->ints[c].reserve(est);
    if (kinds[c] == 's') r->codes[c].reserve(est);
  }
  const char* p = r->data.data();
  const char* end = p + r->data.size();
  for (int64_t s = 0; s < skip_lines && p < end; ++s) {
    const char* q = static_cast<const char*>(memchr(p, '\n', end - p));
    p = q ? q + 1 : end;
  }
  int64_t row = 0;
  while (p < end) {
    const char* q = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* e = q ? q : end;
    const char* next = q ? q + 1 : end;
    if (e > p && e[-1] == '\r') --e;
    if (e == p) {  // a blank line
      p = next;
      continue;
    }
    const char* fp = p;
    for (int64_t c = 0; c < n_cols; ++c) {
      const char* fe = static_cast<const char*>(memchr(fp, ',', e - fp));
      bool last = (c == n_cols - 1);
      if (fe == nullptr) fe = e;
      if ((fe == e) != last) {
        r->status = CSV_FIELDS;
        r->bad_row = row;
        return r;
      }
      if (kinds[c] == 'i') {
        int64_t v;
        if (!parse_int64(fp, fe, &v)) {
          r->status = CSV_NOT_INT;
          r->bad_col = c;
          r->bad_row = row;
          return r;
        }
        r->ints[c].push_back(v);
      } else if (kinds[c] == 's') {
        std::string_view key(fp, static_cast<size_t>(fe - fp));
        auto it = r->intern[c].find(key);
        int32_t code;
        if (it == r->intern[c].end()) {
          code = static_cast<int32_t>(r->strings[c].size());
          r->intern[c].emplace(key, code);
          r->strings[c].push_back(key);
        } else {
          code = it->second;
        }
        r->codes[c].push_back(code);
      }
      fp = fe + 1;
    }
    ++row;
    p = next;
  }
  r->n_rows = row;
  return r;
}

// status, bad column, bad row (0-based, after the skipped lines), rows
void clsr_csv_info(void* rp, int64_t* out) {
  auto* r = static_cast<CsvResult*>(rp);
  out[0] = r->status;
  out[1] = r->bad_col;
  out[2] = r->bad_row;
  out[3] = r->n_rows;
}

void clsr_csv_fill_ints(void* rp, int64_t col, int64_t* out) {
  auto& v = static_cast<CsvResult*>(rp)->ints[col];
  memcpy(out, v.data(), v.size() * sizeof(int64_t));
}

void clsr_csv_fill_codes(void* rp, int64_t col, int32_t* out) {
  auto& v = static_cast<CsvResult*>(rp)->codes[col];
  memcpy(out, v.data(), v.size() * sizeof(int32_t));
}

// the column's distinct strings, '\n'-joined in code order: its byte
// count, then the bytes
int64_t clsr_csv_strings_bytes(void* rp, int64_t col) {
  int64_t n = 0;
  for (auto& s : static_cast<CsvResult*>(rp)->strings[col]) n += s.size() + 1;
  return n;
}

void clsr_csv_fill_strings(void* rp, int64_t col, char* out) {
  for (auto& s : static_cast<CsvResult*>(rp)->strings[col]) {
    memcpy(out, s.data(), s.size());
    out += s.size();
    *out++ = '\n';
  }
}

void clsr_csv_free(void* rp) { delete static_cast<CsvResult*>(rp); }

}  // extern "C"
