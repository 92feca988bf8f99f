// Native TSV parser of the port's host data path.
//
// A copy of the parse half of clsr_tpu/native/fastparse.cpp, kept here so
// that the port imports and builds nothing of the JAX package.  It parses
// the 8-column TSV (label \t user \t item \t cate \t ts \t item_hist \t
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

}  // extern "C"
