// Native reader of the PlantImpute .gen format (readalphadata,
// cnF2freq.cpp:6542-6667); the port's copy of
// cnf2freq_tpu/native/genread.cc.  The Python reader (io/alpha.py,
// use_native=False) tokenizes per line and evaluates the binomial
// read-count model per cell; at production scale (1e5 individuals x 1e4
// markers) that is minutes of interpreter time for what is a
// memory-bandwidth problem.  This parser reads the file once, caches the
// read-count error model per (reads1, reads2) pair, and hands back flat
// arrays.
//
// Exact semantics mirrored (held to the Python reader by
// tests/test_torch_io.py):
//   - integer tokens 0/1/2 -> allele pairs (1,1)/(1,2)/(2,2) with the
//     flat genotype error; anything else -> unknown pair
//   - "a/b" read-count tokens -> binomial expected per-allele error,
//     implausible (>0.5) rates inverted with the allele flip
//   - mid-row EOF and garbage tokens are reported with the individual's
//     name so the Python wrapper can raise the same ValueError
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct GenFile {
  int64_t n = 0;
  int m = 0;
  std::string names;              // newline-joined row names
  std::vector<int32_t> md;        // [n, m, 2]
  std::vector<double> ms;         // [n, m, 2]
  std::vector<uint8_t> rc;        // [n, m] token was a read-count pair
};

// Binomial(n, 1/2) probability of k, as the Python reader computes it:
// the exact binomial coefficient rounded once to a double, times the
// exact power 2^-n (with -ffp-contract=off the arithmetic below then
// matches the Python reader bit for bit).  Coefficients beyond 128 bits
// (n > 120 reads) fall back to log-gamma.
double binom_pdf(long n, long k) {
  if (n <= 120) {
    unsigned __int128 c = 1;
    long kk = k < n - k ? k : n - k;
    for (long i = 0; i < kk; i++) c = c * (unsigned __int128)(n - i) / (i + 1);
    return (double)c * std::ldexp(1.0, (int)-n);
  }
  return std::exp(lgamma((double)n + 1) - lgamma((double)k + 1) -
                  lgamma((double)(n - k) + 1) + (double)n * std::log(0.5));
}

// _readcount_error (io/alpha.py) / cnF2freq.cpp:6599-6639
void readcount_error(long data, long data2, double* out1, double* out2) {
  double sure1 = 0, sure2 = 0, probsum = 0;
  for (long rl1 = 0; rl1 <= data; rl1++) {
    for (long rl2 = 0; rl2 <= data2; rl2++) {
      long l1 = rl1, l2 = rl2;
      double overall = (data ? binom_pdf(data, l1) : 1.0) *
                       (data2 ? binom_pdf(data2, l2) : 1.0);
      double sb1 = 0.5, sb2 = 0.5;
      for (;;) {
        sb1 = 0.5;
        sb2 = 0.5;
        if (l1 + l2) sb1 = (double)l1 / (double)(l1 + l2);
        if (data + data2 - l1 - l2)
          sb2 = (double)(data2 - l2) / (double)(data + data2 - l1 - l2);
        if (sb1 + 1e-9 > 1 - sb2) break;
        l1 = data - l1;
        l2 = data2 - l2;
      }
      overall *= std::pow(sb1, (double)l1) * std::pow(1 - sb1, (double)l2) *
                 std::pow(sb2, (double)(data2 - l2)) *
                 std::pow(1 - sb2, (double)(data - l1));
      sure1 += sb1 * overall;
      sure2 += sb2 * overall;
      probsum += overall;
    }
  }
  *out1 = sure1 / probsum;
  *out2 = sure2 / probsum;
}

constexpr int32_t kUnknown = 0;

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

void set_err(char* errbuf, int errlen, const std::string& msg) {
  if (errbuf && errlen > 0) {
    snprintf(errbuf, (size_t)errlen, "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

void* gen_load(const char* path, int m, double genotype_error,
               int64_t* n_out, char* errbuf, int errlen) {
  set_err(errbuf, errlen, "");
  FILE* f = fopen(path, "rb");
  if (!f) {
    set_err(errbuf, errlen, std::string("cannot open ") + path);
    return nullptr;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize((size_t)sz);
  if (sz && fread(&buf[0], 1, (size_t)sz, f) != (size_t)sz) {
    fclose(f);
    set_err(errbuf, errlen, std::string("short read on ") + path);
    return nullptr;
  }
  fclose(f);

  auto* gf = new GenFile();
  gf->m = m;
  std::unordered_map<uint64_t, std::pair<double, double>> cache;

  const char* p = buf.data();
  const char* end = p + buf.size();
  auto next_tok = [&](const char** s, const char** e) -> bool {
    while (p < end && is_space(*p)) p++;
    if (p >= end) return false;
    *s = p;
    while (p < end && !is_space(*p)) p++;
    *e = p;
    return true;
  };

  const char *ts, *te;
  while (next_tok(&ts, &te)) {
    std::string name(ts, te);
    if (!gf->names.empty()) gf->names += '\n';
    gf->names += name;
    size_t base = (size_t)gf->n * m;
    // geometric growth: plain resize() reallocates to the exact size,
    // which is O(rows^2) bytes copied over a whole file
    if (gf->md.capacity() < (base + m) * 2) {
      size_t want = std::max(gf->md.capacity() * 2, (base + m) * 2);
      gf->md.reserve(want);
      gf->ms.reserve(want);
      gf->rc.reserve(want / 2);
    }
    gf->md.resize((base + m) * 2, kUnknown);
    gf->ms.resize((base + m) * 2, 0.0);
    gf->rc.resize(base + m, 0);
    for (int x = 0; x < m; x++) {
      if (!next_tok(&ts, &te)) {
        set_err(errbuf, errlen,
                "genotype file ended mid-row: individual '" + name +
                    "' has " + std::to_string(x) + " of " +
                    std::to_string(m) + " marker columns");
        delete gf;
        return nullptr;
      }
      const char* slash = (const char*)memchr(ts, '/', (size_t)(te - ts));
      int32_t* mdc = &gf->md[(base + x) * 2];
      double* msc = &gf->ms[(base + x) * 2];
      char* ep;
      if (!slash) {
        long data = strtol(ts, &ep, 10);
        if (ep != te) {
          set_err(errbuf, errlen, "bad genotype token '" +
                                      std::string(ts, te) +
                                      "' for individual '" + name + "'");
          delete gf;
          return nullptr;
        }
        if (data == 0) {
          mdc[0] = mdc[1] = 1;
        } else if (data == 1) {
          mdc[0] = 1;
          mdc[1] = 2;
        } else if (data == 2) {
          mdc[0] = mdc[1] = 2;
        } else {
          mdc[0] = mdc[1] = kUnknown;
        }
        if (mdc[0] != kUnknown) {
          msc[0] = msc[1] = genotype_error;
        }
      } else {
        gf->rc[base + x] = 1;
        long d1 = strtol(ts, &ep, 10);
        bool ok1 = ep == slash;
        long d2 = strtol(slash + 1, &ep, 10);
        if (!ok1 || ep != te) {
          set_err(errbuf, errlen, "bad read-count token '" +
                                      std::string(ts, te) +
                                      "' for individual '" + name + "'");
          delete gf;
          return nullptr;
        }
        if (d1 == 0 && d2 == 0) {
          mdc[0] = mdc[1] = kUnknown;
        } else {
          uint64_t key = ((uint64_t)(uint32_t)d1 << 32) | (uint32_t)d2;
          auto it = cache.find(key);
          if (it == cache.end()) {
            double s1, s2;
            readcount_error(d1, d2, &s1, &s2);
            it = cache.emplace(key, std::make_pair(s1, s2)).first;
          }
          double sure[2] = {it->second.first, it->second.second};
          int32_t marker[2] = {2, 1};
          for (int k = 0; k < 2; k++) {
            if (sure[k] > 0.5) {
              sure[k] = 1 - sure[k];
              marker[k] = k + 1;
            }
          }
          mdc[0] = marker[0];
          mdc[1] = marker[1];
          msc[0] = sure[0];
          msc[1] = sure[1];
        }
      }
    }
    gf->n++;
  }
  *n_out = gf->n;
  return gf;
}

int64_t gen_names_len(void* h) {
  return (int64_t)((GenFile*)h)->names.size();
}

void gen_names(void* h, char* buf) {
  auto* gf = (GenFile*)h;
  memcpy(buf, gf->names.data(), gf->names.size());
}

void gen_copy(void* h, int32_t* md, double* ms, uint8_t* rc) {
  auto* gf = (GenFile*)h;
  memcpy(md, gf->md.data(), gf->md.size() * sizeof(int32_t));
  memcpy(ms, gf->ms.data(), gf->ms.size() * sizeof(double));
  memcpy(rc, gf->rc.data(), gf->rc.size());
}

void gen_free(void* h) { delete (GenFile*)h; }

}  // extern "C"
