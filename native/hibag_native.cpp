// hibag_tpu native runtime: high-throughput host-side data preparation.
//
// Native counterpart of the reference's native data layer
// (HIBAG_ConvBED src/HIBAG.cpp:1094-1191, TGenotype packing
// src/LibHLA.cpp:585-829): the device compute path consumes dense int8 code
// matrices, so the native layer's job is decode/pack/align throughput for
// biobank-scale inputs, not SIMD scoring (that lives in XLA/Pallas).
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).
//
// Build: make -C native   (produces libhibag_native.so)

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Decode PLINK BED 2-bit genotypes (SNP-major) into int8 codes
// {0,1,2,3=missing}, one row per kept SNP.
//   raw:      packed bytes, n_snp rows of stride ceil(n_samp/4)
//   keep_idx: indices of SNPs to decode (n_keep)
//   out:      [n_keep, n_samp] int8
void hibag_bed_decode(const uint8_t* raw, int64_t n_snp, int64_t n_samp,
                      const int64_t* keep_idx, int64_t n_keep,
                      int8_t* out, int n_threads) {
    static int8_t lut[256][4];
    static bool init = false;
    if (!init) {
        const int8_t cvt[4] = {2, 3, 1, 0};
        for (int b = 0; b < 256; b++)
            for (int k = 0; k < 4; k++)
                lut[b][k] = cvt[(b >> (2 * k)) & 3];
        init = true;
    }
    const int64_t stride = (n_samp + 3) / 4;
    if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;

    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            const uint8_t* src = raw + keep_idx[i] * stride;
            int8_t* dst = out + i * n_samp;
            int64_t j = 0;
            for (int64_t b = 0; b < stride - 1; b++) {
                const int8_t* v = lut[src[b]];
                dst[j++] = v[0]; dst[j++] = v[1];
                dst[j++] = v[2]; dst[j++] = v[3];
            }
            const int8_t* v = lut[src[stride - 1]];
            for (int k = 0; j < n_samp; j++, k++) dst[j] = v[k];
        }
    };
    if (n_threads == 1 || n_keep < 256) {
        work(0, n_keep);
    } else {
        std::vector<std::thread> ts;
        int64_t chunk = (n_keep + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; t++) {
            int64_t lo = t * chunk, hi = lo + chunk;
            if (lo >= n_keep) break;
            if (hi > n_keep) hi = n_keep;
            ts.emplace_back(work, lo, hi);
        }
        for (auto& t : ts) t.join();
    }
}

// Gather + allele-flip target genotypes into a model's SNP space.
//   geno:    [P_t, N] int8 target codes
//   src_idx: per model SNP: source row in geno, or -1 (missing)
//   flip:    per model SNP: 1 = code := 2 - code
//   out:     [N, P_m] int8, missing slots = 3
void hibag_align_codes(const int8_t* geno, int64_t p_t, int64_t n,
                       const int64_t* src_idx, const uint8_t* flip,
                       int64_t p_m, int8_t* out, int n_threads) {
    if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t s = lo; s < hi; s++) {     // sample-major output rows
            int8_t* dst = out + s * p_m;
            for (int64_t m = 0; m < p_m; m++) {
                int64_t src = src_idx[m];
                if (src < 0) { dst[m] = 3; continue; }
                int8_t g = geno[src * n + s];
                if (g > 2) { dst[m] = 3; continue; }
                dst[m] = flip[m] ? (int8_t)(2 - g) : g;
            }
        }
    };
    if (n_threads == 1 || n < 128) {
        work(0, n);
    } else {
        std::vector<std::thread> ts;
        int64_t chunk = (n + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; t++) {
            int64_t lo = t * chunk, hi = lo + chunk;
            if (lo >= n) break;
            if (hi > n) hi = n;
            ts.emplace_back(work, lo, hi);
        }
        for (auto& t : ts) t.join();
    }
}

// Pack haplotype bit strings ('0'/'1' chars, fixed width) into a dense
// {0,1} float32 matrix (device upload layout).
void hibag_pack_haplo(const char* strs, int64_t n_haplo, int64_t n_snp,
                      int64_t pad_snp, float* out) {
    for (int64_t h = 0; h < n_haplo; h++) {
        const char* s = strs + h * n_snp;
        float* dst = out + h * pad_snp;
        for (int64_t j = 0; j < n_snp; j++)
            dst[j] = (s[j] == '1') ? 1.0f : 0.0f;
    }
}

// Parse the sample columns of one VCF data line into REF-allele counts.
//   cells:    pointer to the first sample column (the byte after the
//             FORMAT field's tab), tab-separated, ends at len
//   gt_index: 0-based position of GT within the colon-separated FORMAT
//   out:      [n_samples] uint8 filled with 0/1/2 (copies of REF, capped
//             at 2) or 3 = missing ('.' alleles are skipped; a cell with
//             no numeric allele is missing — matching io/vcf_in.py's
//             Python fallback exactly)
// Returns the number of cells parsed (for validation against n_samples).
int64_t hibag_vcf_gt_codes(const char* cells, int64_t len, int32_t gt_index,
                           uint8_t* out, int64_t n_samples) {
    const char* p = cells;
    const char* end = cells + len;
    int64_t s = 0;
    while (s < n_samples && p <= end) {
        // locate the GT field within this cell
        int colon = 0;
        while (colon < gt_index && p < end && *p != '\t') {
            if (*p == ':') colon++;
            p++;
        }
        int refcnt = 0, seen = 0, bad = 0;
        if (colon == gt_index) {
            while (p < end && *p != '\t' && *p != ':') {
                char c = *p;
                if (c >= '0' && c <= '9') {
                    int v = 0;
                    while (p < end && *p >= '0' && *p <= '9') {
                        v = v * 10 + (*p - '0');
                        p++;
                    }
                    seen++;
                    if (v == 0) refcnt++;
                } else if (c == '.' || c == '/' || c == '|') {
                    p++;
                } else {
                    // non-numeric allele token (e.g. "1/A"): the whole
                    // cell is missing, matching the Python fallback's
                    // int() ValueError path in io/vcf_in.py
                    bad = 1;
                    p++;
                }
            }
        }
        out[s++] = (seen && !bad) ? (uint8_t)(refcnt > 2 ? 2 : refcnt)
                                  : (uint8_t)3;
        // skip the rest of the cell
        while (p < end && *p != '\t') p++;
        p++;  // the tab (or one past end)
    }
    return s;
}

// ---------------------------------------------------------------------
// Ordered-reduction candidate step (parity mode).
//
// Replicates the REFERENCE's per-candidate arithmetic bit-for-bit given
// the same current haplotype list and bootstrap: the per-sample min-
// distance pair lists (CAlg_Prediction::_PrepHaploMatch_def,
// /root/reference/src/LibHLA.cpp:1566-1635), candidate-flagged EM with
// serial pair/sample accumulation and the reference's convergence rule
// (CAlg_EM::PrepareNewSNP + ExpectationMaximization, LibHLA.cpp:1127-1255;
// DoubleHaplosInitFreq freq init LibHLA.cpp:443-459), the rare-haplotype
// erase with serial renormalization (CHaplotypeList::EraseDoubleHaplos,
// LibHLA.cpp:461-515), and the evaluation: per-sample posterior sums
// accumulated SERIALLY in haplotype-list order over allele-group blocks
// with the exp(d*log(MIN_RARE_FREQ)) table, a strict running max over
// allele-pair enumeration order for the best guess, and serial in-bag
// log-lik sums (CAlg_Prediction::_BestGuess_def/_PostProb_def
// LibHLA.cpp:1428-1560, CVariableSelection::_OutOfBagAccuracy/
// _InBagLogLik LibHLA.cpp:1934-1979, EXP table init LibHLA.cpp:167-183).
//
// The production device kernels compute the same quantities with
// factorized reductions whose association order differs in the last
// ulp — enough to flip EXACT floating ties in the greedy accept decision
// (docs/DEVIATIONS.md #3).  This path exists so scripts/parity.py can
// resolve ties identically to the reference's scalar "base" target and
// measure full trajectory identity.  Opt-in via the host trainer's
// eval_mode="ordered"; never used by production paths.
// ---------------------------------------------------------------------

namespace {

constexpr double kMinRareFreq = 1e-5;        // MIN_RARE_FREQ
constexpr double kEmInitValFrac = 0.001;     // EM_INIT_VAL_FRAC
constexpr int kEmMaxIter = 500;              // EM_MaxNum_Iterations
constexpr int kMaxSnp = 128;
const double kEmFuncRelTol = std::sqrt(DBL_EPSILON);

struct ExpTab {
    double v[2 * kMaxSnp + 1];
    ExpTab() {
        for (int i = 0; i <= 2 * kMaxSnp; i++) {
            double x = std::exp(i * std::log(kMinRareFreq));
            v[i] = std::isfinite(x) ? x : 0.0;
        }
        v[0] = 1.0;
    }
};
const ExpTab kExp;

inline int popcnt64(uint64_t x) { return __builtin_popcountll(x); }

// THLAType-pair comparison (reference CHLATypeList::Compare,
// src/LibHLA.h inline): count of matched alleles with consumption.
inline int compare_pair(int p1, int p2, int t1, int t2) {
    int cnt = 0;
    if (p1 == t1 || p1 == t2) {
        cnt = 1;
        if (p1 == t1) t1 = -9; else t2 = -9;
    }
    if (p2 == t1 || p2 == t2) cnt++;
    return cnt;
}

// Per-sample base-pair hamming distances D[n][i][j] over the selected
// SNPs (bit-plane popcount decomposition of the reference's hamm_d
// genotype-vs-pair distance, src/LibHLA.h TGenotype packing).
void base_distances(const uint8_t* bits, int64_t H, int64_t n_snp,
                    const int8_t* geno_sel, int64_t L, int64_t N,
                    uint16_t* D, int n_threads) {
    std::vector<uint64_t> bw(H * 2, 0);
    for (int64_t h = 0; h < H; h++) {
        const uint8_t* row = bits + h * n_snp;
        for (int64_t l = 0; l < n_snp; l++)
            if (row[l]) bw[h * 2 + (l >> 6)] |= 1ULL << (l & 63);
    }
    auto dwork = [&](int64_t lo, int64_t hi) {
        for (int64_t n = lo; n < hi; n++) {
            uint64_t g0[2] = {0, 0}, g1[2] = {0, 0}, g2[2] = {0, 0};
            const int8_t* grow = geno_sel + n * L;
            for (int64_t l = 0; l < n_snp; l++) {
                uint64_t bit = 1ULL << (l & 63);
                int w = (int)(l >> 6);
                switch (grow[l]) {
                    case 0: g0[w] |= bit; break;
                    case 1: g1[w] |= bit; break;
                    case 2: g2[w] |= bit; break;
                    default: break;  // missing: no contribution
                }
            }
            uint64_t valid[2] = {g0[0] | g1[0] | g2[0],
                                 g0[1] | g1[1] | g2[1]};
            uint16_t* dn = D + (size_t)n * H * H;
            for (int64_t i = 0; i < H; i++) {
                const uint64_t* bi = &bw[i * 2];
                for (int64_t j = i; j < H; j++) {
                    const uint64_t* bj = &bw[j * 2];
                    int d = 0;
                    for (int w = 0; w < 2; w++) {
                        uint64_t lo_ = bi[w] ^ bj[w];
                        uint64_t hi_ = bi[w] & bj[w];
                        uint64_t z = valid[w] & ~(lo_ | hi_);
                        d += popcnt64(g0[w] & lo_)
                           + 2 * popcnt64(g0[w] & hi_)
                           + popcnt64(g1[w] & z)
                           + popcnt64(g1[w] & hi_)
                           + 2 * popcnt64(g2[w] & z)
                           + popcnt64(g2[w] & lo_);
                    }
                    dn[i * H + j] = dn[j * H + i] = (uint16_t)d;
                }
            }
        }
    };
    std::vector<std::thread> ts;
    int64_t chunk = (N + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        int64_t lo = t * chunk, hi = std::min(lo + chunk, N);
        if (lo >= N) break;
        ts.emplace_back(dwork, lo, hi);
    }
    for (auto& t : ts) t.join();
}

}  // namespace

// Run the reference's full per-candidate step — doubled-list EM, rare
// erase, OOB-accuracy + in-bag-log-lik evaluation — with its exact serial
// summation orders, for all C candidates.  Inputs:
//   bits      [H, n_snp] uint8 current haplotype bits (allele-grouped
//             reference list order)
//   freq      [H] f64 current frequencies
//   allele    [H] int32 nondecreasing HLA-allele index per haplotype
//   g_cand    [C, N] int8 candidate-SNP genotype codes {0,1,2,3=NA}
//   geno_sel  [N, L] int8 selected-SNP codes (cols 0..n_snp-1)
//   a1, a2    [N] true allele pair (a1 <= a2)
//   is_oob    [N] 1 = out-of-bag sample
//   B         [N] f64 bootstrap counts (>0 = in-bag)
//   total_n   vs.nSamp() (the 0.5/N EM scale denominator)
//   rare_prob max(FRACTION_HAPLO/(2N), MIN_RARE_FREQ)
// Outputs (per candidate c):
//   ok_out    [C] 0 when the candidate is in-bag-monomorphic
//             (PrepareNewSNP's false return) — other outputs undefined
//   fA_out, fB_out [C, H] post-erase doubled freqs by base index and new-
//             SNP bit (0 = dropped slot)
//   acc_out   [C] OOB correct-allele count
//   loss_out  [C] -2 * in-bag log-likelihood
extern "C" void hibag_ordered_step(
    const uint8_t* bits, const double* freq, const int32_t* allele,
    int64_t H, int64_t n_snp,
    const int8_t* g_cand, int64_t C,
    const int8_t* geno_sel, int64_t L,
    const int32_t* a1, const int32_t* a2, const uint8_t* is_oob,
    const double* B, int64_t N, int32_t n_alleles,
    double total_n, double rare_prob,
    int32_t* ok_out, double* fA_out, double* fB_out,
    int32_t* acc_out, double* loss_out, int n_threads) {
    if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;

    // ---- shared per-step state (candidate-independent) -----------------
    std::vector<uint16_t> D((size_t)N * H * H);
    base_distances(bits, H, n_snp, geno_sel, L, N, D.data(), n_threads);

    // group layout of the current list (LenPerHLA / StartIdx)
    std::vector<int64_t> glen(n_alleles, 0), gstart(n_alleles, 0);
    for (int64_t h = 0; h < H; h++) glen[allele[h]]++;
    for (int32_t a = 1; a < n_alleles; a++)
        gstart[a] = gstart[a - 1] + glen[a - 1];

    // per-in-bag-sample doubled-list pair lists in _PrepHaploMatch_def
    // order: enumerate the sample's (allele1-group x allele2-group)
    // doubled block in doubled-index order, keep pairs whose BASE
    // distance equals the block minimum (all four bit-combinations of a
    // base pair share its distance).  idx_inbag order = sample order.
    struct Pair { int32_t i1, i2; };
    std::vector<int64_t> inbag;
    for (int64_t n = 0; n < N; n++) if (B[n] > 0) inbag.push_back(n);
    const int64_t NI = (int64_t)inbag.size();
    std::vector<std::vector<Pair>> plists(NI);
    {
        auto pwork = [&](int64_t lo, int64_t hi) {
            for (int64_t s = lo; s < hi; s++) {
                const int64_t n = inbag[s];
                const uint16_t* dn = &D[(size_t)n * H * H];
                const int ha = a1[n], hb = a2[n];
                const int64_t s1 = gstart[ha], n1 = glen[ha];
                const int64_t s2 = gstart[hb], n2 = glen[hb];
                std::vector<Pair>& pl = plists[s];
                int mind = (int)n_snp * 4;
                if (ha != hb) {
                    for (int64_t i = 0; i < n1; i++)
                        for (int64_t j = 0; j < n2; j++) {
                            int d = dn[(s1 + i) * H + (s2 + j)];
                            if (d < mind) mind = d;
                        }
                    for (int64_t i = 0; i < n1; i++)
                        for (int64_t bi = 0; bi < 2; bi++)
                            for (int64_t j = 0; j < n2; j++)
                                for (int64_t bj = 0; bj < 2; bj++)
                                    if (dn[(s1 + i) * H + (s2 + j)] == mind)
                                        pl.push_back(Pair{
                                            (int32_t)(2 * (s1 + i) + bi),
                                            (int32_t)(2 * (s2 + j) + bj)});
                } else {
                    for (int64_t i = 0; i < n1; i++)
                        for (int64_t j = i; j < n1; j++) {
                            int d = dn[(s1 + i) * H + (s1 + j)];
                            if (d < mind) mind = d;
                        }
                    // doubled diagonal block: p2 starts AT p1
                    for (int64_t di = 0; di < 2 * n1; di++)
                        for (int64_t dj = di; dj < 2 * n1; dj++) {
                            int64_t i = s1 + di / 2, j = s1 + dj / 2;
                            if (dn[i * H + j] == mind)
                                pl.push_back(Pair{
                                    (int32_t)(2 * i + (di & 1)),
                                    (int32_t)(2 * j + (dj & 1))});
                        }
                }
            }
        };
        std::vector<std::thread> ts;
        int64_t chunk = (NI + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; t++) {
            int64_t lo = t * chunk, hi = std::min(lo + chunk, NI);
            if (lo >= NI) break;
            ts.emplace_back(pwork, lo, hi);
        }
        for (auto& t : ts) t.join();
    }

    // ---- per-candidate EM + erase + eval --------------------------------
    auto cwork = [&](int64_t c0, int64_t c1) {
        const int64_t H2 = 2 * H;
        std::vector<double> f(H2), of(H2);          // Freq / aux.OldFreq
        std::vector<uint8_t> flag;
        std::vector<double> gf;                     // per-pair GenoFreq
        std::vector<double> log_buf(NI);
        std::vector<int64_t> pstart(NI + 1);
        // doubled-list scratch for the post-erase eval
        std::vector<int32_t> db_base, db_bit;
        std::vector<double> db_freq;
        std::vector<int64_t> len_per_hla(n_alleles);

        for (int64_t c = c0; c < c1; c++) {
            const int8_t* gc_row = g_cand + c * N;

            // PrepareNewSNP: in-bag allele frequency + monomorphic check
            int64_t allele_cnt = 0, valid_cnt = 0;
            for (int64_t s = 0; s < NI; s++) {
                const int64_t n = inbag[s];
                const int g = gc_row[n];
                if (0 <= g && g <= 2) {
                    allele_cnt += (int64_t)(g * B[n]);
                    valid_cnt += (int64_t)(2 * B[n]);
                }
            }
            if (allele_cnt == 0 || allele_cnt == valid_cnt) {
                ok_out[c] = 0;
                acc_out[c] = 0; loss_out[c] = 0;
                for (int64_t h = 0; h < H; h++) {
                    fA_out[c * H + h] = 0; fB_out[c * H + h] = 0;
                }
                continue;
            }
            ok_out[c] = 1;
            const double afreq = double(allele_cnt) / valid_cnt;

            // DoubleHaplosInitFreq
            const double p0 = 1 - afreq, p1 = afreq;
            for (int64_t h = 0; h < H; h++) {
                f[2 * h] = p0 * freq[h] + kEmInitValFrac;
                f[2 * h + 1] = p1 * freq[h] + kEmInitValFrac;
            }

            // flatten the pair lists with per-candidate flags
            int64_t npair = 0;
            for (int64_t s = 0; s < NI; s++) {
                pstart[s] = npair;
                npair += (int64_t)plists[s].size();
            }
            pstart[NI] = npair;
            flag.assign(npair, 1);
            gf.assign(npair, 0.0);
            for (int64_t s = 0; s < NI; s++) {
                const int g = gc_row[inbag[s]];
                if (0 <= g && g <= 2) {
                    const std::vector<Pair>& pl = plists[s];
                    for (size_t k = 0; k < pl.size(); k++)
                        flag[pstart[s] + k] =
                            ((pl[k].i1 & 1) + (pl[k].i2 & 1)) == g;
                }
            }

            // ExpectationMaximization (serial reference order)
            double conv_tol = 0, loglik = -1e+30;
            for (int iter = 0; iter <= kEmMaxIter; iter++) {
                const double old_loglik = loglik;
                for (int64_t i = 0; i < H2; i++) { of[i] = f[i]; f[i] = 0; }
                for (int64_t s = 0; s < NI; s++) {
                    const std::vector<Pair>& pl = plists[s];
                    double psum = 0;
                    for (size_t k = 0; k < pl.size(); k++) {
                        if (!flag[pstart[s] + k]) continue;
                        const Pair& pr = pl[k];
                        double v = (pr.i1 != pr.i2)
                            ? 2 * of[pr.i1] * of[pr.i2]
                            : of[pr.i1] * of[pr.i2];
                        gf[pstart[s] + k] = v;
                        psum += v;
                    }
                    const double bc = B[inbag[s]];
                    log_buf[s] = bc * std::log(psum);
                    const double inv = bc / psum;
                    for (size_t k = 0; k < pl.size(); k++)
                        if (flag[pstart[s] + k]) gf[pstart[s] + k] *= inv;
                }
                loglik = 0;
                for (int64_t s = 0; s < NI; s++) {
                    loglik += log_buf[s];
                    const std::vector<Pair>& pl = plists[s];
                    for (size_t k = 0; k < pl.size(); k++) {
                        if (!flag[pstart[s] + k]) continue;
                        const double r = gf[pstart[s] + k];
                        f[pl[k].i1] += r;
                        f[pl[k].i2] += r;
                    }
                }
                const double scale = 0.5 / total_n;
                for (int64_t i = 0; i < H2; i++) f[i] *= scale;
                if (iter > 0) {
                    if (std::fabs(loglik - old_loglik) <= conv_tol) break;
                } else {
                    conv_tol = kEmFuncRelTol
                             * (std::fabs(loglik) + kEmFuncRelTol);
                    if (conv_tol < 0) conv_tol = 0;
                }
            }

            // EraseDoubleHaplos (serial sum in list order, one rescale)
            double sum = 0;
            double* fa = fA_out + c * H;
            double* fb = fB_out + c * H;
            for (int64_t h = 0; h < H; h++) {
                const double f0 = f[2 * h], f1 = f[2 * h + 1];
                const double sumfreq = f0 + f1;
                if (f0 < rare_prob || f1 < rare_prob) {
                    fa[h] = fb[h] = 0;
                    if (sumfreq >= kMinRareFreq) {
                        if (f0 >= f1) fa[h] = sumfreq;
                        else fb[h] = sumfreq;
                        sum += sumfreq;
                    }
                } else {
                    fa[h] = f0; fb[h] = f1;
                    sum += sumfreq;
                }
            }
            const double rescale = 1 / sum;
            for (int64_t h = 0; h < H; h++) {
                fa[h] *= rescale; fb[h] *= rescale;
            }

            // ---- evaluation over the post-erase doubled list -----------
            db_base.clear(); db_bit.clear(); db_freq.clear();
            std::fill(len_per_hla.begin(), len_per_hla.end(), 0);
            for (int64_t h = 0; h < H; h++) {
                if (fa[h] > 0) {
                    db_base.push_back((int32_t)h); db_bit.push_back(0);
                    db_freq.push_back(fa[h]); len_per_hla[allele[h]]++;
                }
                if (fb[h] > 0) {
                    db_base.push_back((int32_t)h); db_bit.push_back(1);
                    db_freq.push_back(fb[h]); len_per_hla[allele[h]]++;
                }
            }

            int64_t acc = 0;
            double ll = 0.0;
            for (int64_t n = 0; n < N; n++) {
                const int8_t g = gc_row[n];
                int dtab[3];
                switch (g) {
                    case 0: dtab[0] = 0; dtab[1] = 1; dtab[2] = 2; break;
                    case 1: dtab[0] = 1; dtab[1] = 0; dtab[2] = 1; break;
                    case 2: dtab[0] = 2; dtab[1] = 1; dtab[2] = 0; break;
                    default: dtab[0] = dtab[1] = dtab[2] = 0; break;
                }
                const uint16_t* dn = &D[(size_t)n * H * H];
                const bool oob = is_oob[n] != 0;
                const bool ib = B[n] > 0;
                if (!oob && !ib) continue;
                int ixhla = -1;
                if (ib) {
                    const int h1t = a1[n], h2t = a2[n];
                    ixhla = h2t + h1t * (2 * n_alleles - h1t - 1) / 2;
                }
                double maxp = 0, ssum = 0, hlaprob = 0;
                int rv1 = -1, rv2 = -1, idx = 0;
                int64_t I1 = 0;
                for (int h1 = 0; h1 < n_alleles; h1++) {
                    const int64_t n1 = len_per_hla[h1];
                    double prob = 0;
                    for (int64_t m1 = 0; m1 < n1; m1++) {
                        const int64_t i1 = I1 + m1;
                        const int bi1 = db_bit[i1];
                        const uint16_t* drow =
                            dn + (size_t)db_base[i1] * H;
                        prob += db_freq[i1] * db_freq[i1]
                              * kExp.v[drow[db_base[i1]]
                                       + dtab[2 * bi1]];
                        const double ff = 2 * db_freq[i1];
                        for (int64_t m2 = m1 + 1; m2 < n1; m2++) {
                            const int64_t i2 = I1 + m2;
                            prob += ff * db_freq[i2]
                                  * kExp.v[drow[db_base[i2]]
                                           + dtab[bi1 + db_bit[i2]]];
                        }
                    }
                    int64_t I2 = I1 + n1;
                    if (oob && maxp < prob) { maxp = prob; rv1 = rv2 = h1; }
                    if (ib) {
                        if (ixhla == idx) hlaprob = prob;
                        ssum += prob;
                    }
                    idx++;
                    for (int h2 = h1 + 1; h2 < n_alleles; h2++) {
                        const int64_t n2 = len_per_hla[h2];
                        prob = 0;
                        for (int64_t m1 = 0; m1 < n1; m1++) {
                            const int64_t i1 = I1 + m1;
                            const int bi1 = db_bit[i1];
                            const double ff = 2 * db_freq[i1];
                            const uint16_t* drow =
                                dn + (size_t)db_base[i1] * H;
                            for (int64_t m2 = 0; m2 < n2; m2++) {
                                const int64_t i2 = I2 + m2;
                                prob += ff * db_freq[i2]
                                      * kExp.v[drow[db_base[i2]]
                                               + dtab[bi1 + db_bit[i2]]];
                            }
                        }
                        I2 += n2;
                        if (oob && maxp < prob) {
                            maxp = prob; rv1 = h1; rv2 = h2;
                        }
                        if (ib) {
                            if (ixhla == idx) hlaprob = prob;
                            ssum += prob;
                        }
                        idx++;
                    }
                    I1 += n1;
                }
                if (oob)
                    acc += compare_pair(rv1, rv2, a1[n], a2[n]);
                else
                    ll += B[n] * std::log(hlaprob / ssum);
            }
            acc_out[c] = (int32_t)acc;
            loss_out[c] = -2.0 * ll;
        }
    };
    std::vector<std::thread> ts;
    int64_t chunk = (C + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        int64_t lo = t * chunk, hi = std::min(lo + chunk, C);
        if (lo >= C) break;
        ts.emplace_back(cwork, lo, hi);
    }
    for (auto& t : ts) t.join();
}


// Per-SNP allele frequency and missing rate over an int8 code matrix
// geno [P, N]; outputs freq[P], miss[P].
void hibag_snp_stats(const int8_t* geno, int64_t p, int64_t n,
                     double* freq, double* miss, int n_threads) {
    if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            const int8_t* row = geno + i * n;
            int64_t cnt = 0, valid = 0;
            for (int64_t j = 0; j < n; j++) {
                int8_t g = row[j];
                if (g <= 2) { cnt += g; valid++; }
            }
            freq[i] = valid ? (double)cnt / (2.0 * valid) : 0.0;
            miss[i] = 1.0 - (double)valid / n;
        }
    };
    if (n_threads == 1 || p < 1024) {
        work(0, p);
    } else {
        std::vector<std::thread> ts;
        int64_t chunk = (p + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; t++) {
            int64_t lo = t * chunk, hi = lo + chunk;
            if (lo >= p) break;
            if (hi > p) hi = p;
            ts.emplace_back(work, lo, hi);
        }
        for (auto& t : ts) t.join();
    }
}

}  // extern "C"
