// BC7 multi-mode block encoder (native half of tools/make_ntex.py).
//
// The reference's make-ntex CLI compresses textures with the native intel_tex
// BC7 encoder at slow settings with alpha-aware mode selection (reference:
// make-ntex/src/main.rs:231-246); this is this renderer's equivalent. ALL 8
// BC7 modes are considered; per 4x4 block the encoder keeps the lowest
// reconstruction error of the tried set:
//   mode 6  — 1 subset, 7.7.7.7+p endpoints, 4-bit indices (the solid RGBA
//             workhorse; also the only mode of the round<5 encoder)
//   mode 0  — 3 subsets (16 partitions), RGB 4.4.4 + per-endpoint p, 3-bit
//             indices (three color regions in one block)
//   mode 1  — 2 subsets, RGB 6.6.6 + shared p-bit, 3-bit indices (opaque
//             blocks whose colors do not fit ONE line: edges/gradients)
//   mode 2  — 3 subsets (64 partitions), RGB 5.5.5, 2-bit indices
//   mode 3  — 2 subsets, RGB 7.7.7 + per-endpoint p, 2-bit indices (two
//             smooth regions: endpoint precision over index resolution)
//   mode 4  — 1 subset, rotation, selectable index widths: RGB 5.5 +
//             separate alpha 6.6, one 2-bit + one 3-bit index plane
//   mode 5  — 1 subset, rotation, RGB 7.7 + SEPARATE alpha 8.8 plane,
//             2+2-bit indices (smooth independent alpha)
//   mode 7  — 2 subsets, RGBA 5.5.5.5+p, 2-bit indices (sharp alpha that
//             correlates with a 2-subset color split: cutout edges)
// The alpha-aware gating mirrors intel_tex's: modes 0/1/2/3 are tried only
// on fully-opaque blocks (they decode alpha=255), modes 4/5/7 only when the
// block has alpha<255 (they can't beat 6 on opaque content but cost the
// full search); mode 6 is always tried. Modes 4/5 additionally search the
// 4 channel rotations (trading the dedicated scalar plane to R/G/B — the
// decorrelated-channel case). The 2-subset partition search scores all 64
// patterns with a per-subset variance proxy and fully evaluates the best 8;
// the 3-subset search evaluates the best 4 (the slow-settings analog).
//
// The partition/anchor tables are PASSED IN from Python
// (renderer_tpu/materials/bc7_tables.py — empirically recovered from
// Pillow's decoder, the repo's single table source).
//
// Build: make (g++ -O3 -shared -fPIC); loaded via ctypes from
// renderer_tpu/tools/native.py with a numpy (mode-6-only) fallback.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

namespace {

const int kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};
const int kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kWeights2[4] = {0, 21, 43, 64};

struct BitWriter {
  uint8_t* out;
  int bit = 0;
  explicit BitWriter(uint8_t* o) : out(o) { std::memset(o, 0, 16); }
  void put(uint32_t value, int nbits) {
    for (int i = 0; i < nbits; i++) {
      if ((value >> i) & 1) out[bit >> 3] |= uint8_t(1u << (bit & 7));
      bit++;
    }
  }
};

inline int interp(int e0, int e1, int w) { return (e0 * (64 - w) + e1 * w + 32) >> 6; }

// defined below (shared by every mode): PCA endpoints + quantize + index
// fit + least-squares refinement rounds
double fit_subset(const float px[16][4], const uint8_t* mask, int subset,
                  int bits, int p0, int p1, int has_p,
                  const int* wts, int nidx, int nch,
                  int q0[4], int q1[4], int idx[16]);

double encode_block_mode6(const float px[16][4], uint8_t* out) {
  // pick p-bits + endpoints + indices minimizing total squared error
  // (4 p combos × PCA + LS-refined 7-bit endpoints + exact index search)
  int best_q[2][4];
  int best_p[2] = {0, 0};
  int best_idx[16];
  double best_err = 1e30;
  for (int p0 = 0; p0 < 2; p0++)
    for (int p1 = 0; p1 < 2; p1++) {
      int q0[4], q1[4], idx[16];
      double err = fit_subset(px, nullptr, 0, 7, p0, p1, 1, kWeights4, 16,
                              4, q0, q1, idx);
      if (err < best_err) {
        best_err = err;
        std::memcpy(best_q[0], q0, sizeof(q0));
        std::memcpy(best_q[1], q1, sizeof(q1));
        best_p[0] = p0;
        best_p[1] = p1;
        std::memcpy(best_idx, idx, sizeof(idx));
      }
    }

  // anchor rule: index 0 must have MSB 0; otherwise swap endpoints
  if (best_idx[0] >= 8) {
    std::swap(best_q[0], best_q[1]);
    std::swap(best_p[0], best_p[1]);
    for (int i = 0; i < 16; i++) best_idx[i] = 15 - best_idx[i];
  }

  BitWriter bw(out);
  bw.put(1u << 6, 7);  // mode 6
  for (int c = 0; c < 4; c++) {  // R0 R1 G0 G1 B0 B1 A0 A1
    bw.put(uint32_t(best_q[0][c]), 7);
    bw.put(uint32_t(best_q[1][c]), 7);
  }
  bw.put(uint32_t(best_p[0]), 1);
  bw.put(uint32_t(best_p[1]), 1);
  bw.put(uint32_t(best_idx[0]), 3);  // anchor: implicit 0 MSB
  for (int i = 1; i < 16; i++) bw.put(uint32_t(best_idx[i]), 4);
  return best_err;
}

// ---- shared helpers for modes 1/5/7 -----------------------------------------

// reconstruct an 8-bit endpoint channel from `bits` stored bits (+ optional
// appended p-bit): left-align then replicate the top bits (the BC7 rule)
inline int expand_ep(int q, int bits, int p, int has_p) {
  int v = q, total = bits;
  if (has_p) { v = (q << 1) | p; total = bits + 1; }
  return (v << (8 - total)) | (v >> (2 * total - 8));
}

// exhaustive channel quantization against the reconstruction rule
inline int quant_channel(float target, int bits, int p, int has_p) {
  int best = 0;
  float be = 1e30f;
  for (int q = 0; q < (1 << bits); q++) {
    float e = std::fabs(float(expand_ep(q, bits, p, has_p)) - target);
    if (e < be) { be = e; best = q; }
  }
  return best;
}

// PCA line fit over the texels of one subset (nch channels)
void subset_endpoints(const float px[16][4], const uint8_t* mask, int subset,
                      int nch, float ep0[4], float ep1[4]) {
  float mean[4] = {0, 0, 0, 0};
  int n = 0;
  for (int i = 0; i < 16; i++)
    if (!mask || mask[i] == subset) {
      n++;
      for (int c = 0; c < nch; c++) mean[c] += px[i][c];
    }
  ep0[3] = ep1[3] = 255.0f;
  if (!n) { for (int c = 0; c < nch; c++) ep0[c] = ep1[c] = 0; return; }
  for (int c = 0; c < nch; c++) mean[c] /= float(n);
  float cov[4][4] = {};
  for (int i = 0; i < 16; i++)
    if (!mask || mask[i] == subset) {
      float d[4];
      for (int c = 0; c < nch; c++) d[c] = px[i][c] - mean[c];
      for (int a = 0; a < nch; a++)
        for (int b = 0; b < nch; b++) cov[a][b] += d[a] * d[b];
    }
  float axis[4] = {1, 1, 1, nch == 4 ? 1.0f : 0.0f};
  for (int it = 0; it < 8; it++) {
    float nx[4] = {};
    for (int a = 0; a < nch; a++)
      for (int b = 0; b < nch; b++) nx[a] += cov[a][b] * axis[b];
    float norm = 0;
    for (int c = 0; c < nch; c++) norm += nx[c] * nx[c];
    norm = std::sqrt(norm);
    if (norm < 1e-9f) break;
    for (int c = 0; c < nch; c++) axis[c] = nx[c] / norm;
  }
  float tmin = 1e30f, tmax = -1e30f;
  for (int i = 0; i < 16; i++)
    if (!mask || mask[i] == subset) {
      float t = 0;
      for (int c = 0; c < nch; c++) t += (px[i][c] - mean[c]) * axis[c];
      tmin = std::min(tmin, t);
      tmax = std::max(tmax, t);
    }
  for (int c = 0; c < nch; c++) {
    ep0[c] = std::max(0.0f, std::min(255.0f, mean[c] + tmin * axis[c]));
    ep1[c] = std::max(0.0f, std::min(255.0f, mean[c] + tmax * axis[c]));
  }
}

// best index per texel of `subset` against the (r0, r1, wts) palette;
// accumulates squared error over nch_err channels
double fit_indices(const float px[16][4], const uint8_t* mask, int subset,
                   const int r0[4], const int r1[4], const int* wts, int nidx,
                   int nch_err, int idx[16]) {
  double err = 0;
  for (int i = 0; i < 16; i++) {
    if (mask && mask[i] != subset) continue;
    double be = 1e30;
    int bj = 0;
    for (int j = 0; j < nidx; j++) {
      double e = 0;
      for (int c = 0; c < nch_err; c++) {
        double d = double(interp(r0[c], r1[c], wts[j])) - px[i][c];
        e += d * d;
      }
      if (e < be) { be = e; bj = j; }
    }
    idx[i] = bj;
    err += be;
  }
  return err;
}

// rank n-subset partitions by a cheap proxy (total squared deviation from
// per-subset means) and return the `ncand` best into cand[]
void rank_partitions_n(const float px[16][4], const uint8_t* parts, int npart,
                       int nsub, int nch, int ncand, int cand[]) {
  double score[64];
  for (int pi = 0; pi < npart; pi++) {
    const uint8_t* mask = parts + pi * 16;
    double s = 0;
    for (int sub = 0; sub < nsub; sub++) {
      float mean[4] = {0, 0, 0, 0};
      int n = 0;
      for (int i = 0; i < 16; i++)
        if (mask[i] == sub) {
          n++;
          for (int c = 0; c < nch; c++) mean[c] += px[i][c];
        }
      if (!n) continue;
      for (int c = 0; c < nch; c++) mean[c] /= float(n);
      for (int i = 0; i < 16; i++)
        if (mask[i] == sub)
          for (int c = 0; c < nch; c++) {
            double d = px[i][c] - mean[c];
            s += d * d;
          }
    }
    score[pi] = s;
  }
  for (int k = 0; k < ncand; k++) {
    int best = -1;
    for (int pi = 0; pi < npart; pi++) {
      bool used = false;
      for (int j = 0; j < k; j++) used |= (cand[j] == pi);
      if (used) continue;
      if (best < 0 || score[pi] < score[best]) best = pi;
    }
    cand[k] = best;
  }
}

void rank_partitions(const float px[16][4], const uint8_t* parts, int nch,
                     int ncand, int cand[]) {
  rank_partitions_n(px, parts, 64, 2, nch, ncand, cand);
}

// least-squares endpoint refinement: given the current indices, solve the
// 2x2 normal equations per channel for the best CONTINUOUS endpoints, then
// the caller requantizes + refits indices (the intel_tex slow-settings
// style inner loop). Returns false when the system is degenerate (all
// texels on one palette entry).
bool ls_endpoints(const float px[16][4], const uint8_t* mask, int subset,
                  const int* wts, const int idx[16], int nch,
                  float e0[4], float e1[4]) {
  double a = 0, b = 0, c = 0, d0[4] = {0, 0, 0, 0}, d1[4] = {0, 0, 0, 0};
  for (int i = 0; i < 16; i++) {
    if (mask && mask[i] != subset) continue;
    double w = wts[idx[i]] / 64.0, u = 1.0 - w;
    a += u * u;
    b += u * w;
    c += w * w;
    for (int ch = 0; ch < nch; ch++) {
      d0[ch] += u * px[i][ch];
      d1[ch] += w * px[i][ch];
    }
  }
  double det = a * c - b * b;
  if (std::fabs(det) < 1e-8) return false;
  for (int ch = 0; ch < nch; ch++) {
    double v0 = (c * d0[ch] - b * d1[ch]) / det;
    double v1 = (a * d1[ch] - b * d0[ch]) / det;
    e0[ch] = float(std::max(0.0, std::min(255.0, v0)));
    e1[ch] = float(std::max(0.0, std::min(255.0, v1)));
  }
  return true;
}

// quantize endpoints at (bits, p) precision, fit indices, then up to two
// LS-refine → requantize → refit rounds, keeping the best. Fills q0/q1 and
// idx (texels of `subset` only); returns the subset's squared error.
double fit_subset(const float px[16][4], const uint8_t* mask, int subset,
                  int bits, int p0, int p1, int has_p,
                  const int* wts, int nidx, int nch,
                  int q0[4], int q1[4], int idx[16]) {
  float e0[4], e1[4];
  subset_endpoints(px, mask, subset, nch, e0, e1);
  double best = 1e30;
  int bq0[4] = {0, 0, 0, 0}, bq1[4] = {0, 0, 0, 0}, bidx[16] = {};
  for (int round = 0; round < 3; round++) {
    int tq0[4], tq1[4], r0[4], r1[4], tidx[16];
    for (int c = 0; c < nch; c++) {
      tq0[c] = quant_channel(e0[c], bits, p0, has_p);
      tq1[c] = quant_channel(e1[c], bits, p1, has_p);
      r0[c] = expand_ep(tq0[c], bits, p0, has_p);
      r1[c] = expand_ep(tq1[c], bits, p1, has_p);
    }
    double e = fit_indices(px, mask, subset, r0, r1, wts, nidx, nch, tidx);
    if (e < best) {
      best = e;
      std::memcpy(bq0, tq0, sizeof(tq0));
      std::memcpy(bq1, tq1, sizeof(tq1));
      std::memcpy(bidx, tidx, sizeof(tidx));
    }
    if (round == 2 ||
        !ls_endpoints(px, mask, subset, wts, tidx, nch, e0, e1))
      break;
  }
  std::memcpy(q0, bq0, sizeof(bq0));
  std::memcpy(q1, bq1, sizeof(bq1));
  // all 16 slots written (non-subset texels get 0); callers merge subsets
  // under their own mask guard
  std::memcpy(idx, bidx, sizeof(bidx));
  return best;
}

// mode 1: 2 subsets, RGB 6.6.6 + shared p-bit/subset, 3-bit indices.
// Decodes alpha=255 — callers gate it on fully-opaque blocks.
double encode_mode1(const float px[16][4], const uint8_t* parts,
                    const uint8_t* anchors, uint8_t* out) {
  int cand[8];
  rank_partitions(px, parts, 3, 8, cand);
  double best_err = 1e30;
  for (int k = 0; k < 8; k++) {
    int pi = cand[k];
    const uint8_t* mask = parts + pi * 16;
    int q[2][2][3], pbit[2], idx[16];
    double perr = 0;
    for (int s = 0; s < 2; s++) {
      double sbest = 1e30;
      for (int p = 0; p < 2; p++) {
        int q0[4], q1[4], sidx[16];
        double e = fit_subset(px, mask, s, 6, p, p, 1, kWeights3, 8, 3,
                              q0, q1, sidx);
        if (e < sbest) {
          sbest = e;
          pbit[s] = p;
          for (int c = 0; c < 3; c++) { q[s][0][c] = q0[c]; q[s][1][c] = q1[c]; }
          for (int i = 0; i < 16; i++)
            if (mask[i] == s) idx[i] = sidx[i];
        }
      }
      perr += sbest;
    }
    if (perr >= best_err) continue;
    best_err = perr;
    // anchor MSB rule per subset: texel 0 anchors subset 0, anchors[pi]
    // anchors subset 1 — swap that subset's endpoints + invert its indices
    int anchor_of[2] = {0, anchors[pi]};
    int qq[2][2][3];
    std::memcpy(qq, q, sizeof(q));
    int fidx[16];
    std::memcpy(fidx, idx, sizeof(idx));
    for (int s = 0; s < 2; s++) {
      if (fidx[anchor_of[s]] >= 4) {
        for (int c = 0; c < 3; c++) std::swap(qq[s][0][c], qq[s][1][c]);
        for (int i = 0; i < 16; i++)
          if (mask[i] == s) fidx[i] = 7 - fidx[i];
      }
    }
    BitWriter bw(out);
    bw.put(1u << 1, 2);  // mode 1
    bw.put(uint32_t(pi), 6);
    for (int c = 0; c < 3; c++)
      for (int s = 0; s < 2; s++)
        for (int e = 0; e < 2; e++) bw.put(uint32_t(qq[s][e][c]), 6);
    bw.put(uint32_t(pbit[0]), 1);
    bw.put(uint32_t(pbit[1]), 1);
    for (int i = 0; i < 16; i++) {
      bool anchor = (i == 0) || (i == anchor_of[1]);
      bw.put(uint32_t(fidx[i]), anchor ? 2 : 3);
    }
  }
  return best_err;
}

// mode 3: 2 subsets, RGB 7.7.7 + per-endpoint p-bit, 2-bit indices — the
// high-endpoint-precision complement to mode 1 (wins when each subset is a
// smooth gradient that 2-bit indices resolve but 6-bit endpoints band)
double encode_mode3(const float px[16][4], const uint8_t* parts,
                    const uint8_t* anchors, uint8_t* out) {
  int cand[8];
  rank_partitions(px, parts, 3, 8, cand);
  double best_err = 1e30;
  for (int k = 0; k < 8; k++) {
    int pi = cand[k];
    const uint8_t* mask = parts + pi * 16;
    int q[2][2][3], pb[2][2], idx[16];
    double perr = 0;
    for (int s = 0; s < 2; s++) {
      double sbest = 1e30;
      for (int pc = 0; pc < 4; pc++) {
        int p0 = pc & 1, p1 = pc >> 1;
        int q0[4], q1[4], sidx[16];
        double e = fit_subset(px, mask, s, 7, p0, p1, 1, kWeights2, 4, 3,
                              q0, q1, sidx);
        if (e < sbest) {
          sbest = e;
          pb[s][0] = p0;
          pb[s][1] = p1;
          for (int c = 0; c < 3; c++) { q[s][0][c] = q0[c]; q[s][1][c] = q1[c]; }
          for (int i = 0; i < 16; i++)
            if (mask[i] == s) idx[i] = sidx[i];
        }
      }
      perr += sbest;
    }
    if (perr >= best_err) continue;
    best_err = perr;
    int anchor_of[2] = {0, anchors[pi]};
    int qq[2][2][3], pp[2][2], fidx[16];
    std::memcpy(qq, q, sizeof(q));
    std::memcpy(pp, pb, sizeof(pb));
    std::memcpy(fidx, idx, sizeof(idx));
    for (int s = 0; s < 2; s++) {
      if (fidx[anchor_of[s]] >= 2) {
        for (int c = 0; c < 3; c++) std::swap(qq[s][0][c], qq[s][1][c]);
        std::swap(pp[s][0], pp[s][1]);
        for (int i = 0; i < 16; i++)
          if (mask[i] == s) fidx[i] = 3 - fidx[i];
      }
    }
    BitWriter bw(out);
    bw.put(1u << 3, 4);  // mode 3
    bw.put(uint32_t(pi), 6);
    for (int c = 0; c < 3; c++)
      for (int s = 0; s < 2; s++)
        for (int e = 0; e < 2; e++) bw.put(uint32_t(qq[s][e][c]), 7);
    for (int s = 0; s < 2; s++)
      for (int e = 0; e < 2; e++) bw.put(uint32_t(pp[s][e]), 1);
    for (int i = 0; i < 16; i++) {
      bool anchor = (i == 0) || (i == anchor_of[1]);
      bw.put(uint32_t(fidx[i]), anchor ? 1 : 2);
    }
  }
  return best_err;
}

// modes 0 and 2: 3 subsets of RGB. Mode 0 = 16 partitions, 4.4.4 +
// per-endpoint p, 3-bit indices; mode 2 = 64 partitions, 5.5.5, 2-bit
// indices. Three-cluster blocks that no single or 2-subset line fits.
double encode_mode0or2(const float px[16][4], int mode, const uint8_t* parts3,
                       const uint8_t* anchors32, const uint8_t* anchors33,
                       uint8_t* out) {
  const int npart = (mode == 0) ? 16 : 64;
  const int bits = (mode == 0) ? 4 : 5;
  const int has_p = (mode == 0) ? 1 : 0;
  const int* wts = (mode == 0) ? kWeights3 : kWeights2;
  const int nidx = (mode == 0) ? 8 : 4;
  int cand[4];
  rank_partitions_n(px, parts3, npart, 3, 3, 4, cand);
  double best_err = 1e30;
  for (int k = 0; k < 4; k++) {
    int pi = cand[k];
    const uint8_t* mask = parts3 + pi * 16;
    int q[3][2][3], pb[3][2], idx[16] = {};
    double perr = 0;
    for (int s = 0; s < 3; s++) {
      double sbest = 1e30;
      int ncomb = has_p ? 4 : 1;
      for (int pc = 0; pc < ncomb; pc++) {
        int p0 = pc & 1, p1 = pc >> 1;
        int q0[4], q1[4], sidx[16];
        double e = fit_subset(px, mask, s, bits, p0, p1, has_p, wts, nidx, 3,
                              q0, q1, sidx);
        if (e < sbest) {
          sbest = e;
          pb[s][0] = p0;
          pb[s][1] = p1;
          for (int c = 0; c < 3; c++) { q[s][0][c] = q0[c]; q[s][1][c] = q1[c]; }
          for (int i = 0; i < 16; i++)
            if (mask[i] == s) idx[i] = sidx[i];
        }
      }
      perr += sbest;
    }
    if (perr >= best_err) continue;
    best_err = perr;
    int anchor_of[3] = {0, anchors32[pi], anchors33[pi]};
    int qq[3][2][3], pp[3][2], fidx[16];
    std::memcpy(qq, q, sizeof(q));
    std::memcpy(pp, pb, sizeof(pb));
    std::memcpy(fidx, idx, sizeof(idx));
    for (int s = 0; s < 3; s++) {
      if (fidx[anchor_of[s]] >= nidx / 2) {
        for (int c = 0; c < 3; c++) std::swap(qq[s][0][c], qq[s][1][c]);
        std::swap(pp[s][0], pp[s][1]);
        for (int i = 0; i < 16; i++)
          if (mask[i] == s) fidx[i] = (nidx - 1) - fidx[i];
      }
    }
    BitWriter bw(out);
    if (mode == 0) {
      bw.put(1u, 1);  // mode 0
      bw.put(uint32_t(pi), 4);
    } else {
      bw.put(1u << 2, 3);  // mode 2
      bw.put(uint32_t(pi), 6);
    }
    for (int c = 0; c < 3; c++)
      for (int s = 0; s < 3; s++)
        for (int e = 0; e < 2; e++) bw.put(uint32_t(qq[s][e][c]), bits);
    if (has_p)
      for (int s = 0; s < 3; s++)
        for (int e = 0; e < 2; e++) bw.put(uint32_t(pp[s][e]), 1);
    int idx_bits = (mode == 0) ? 3 : 2;
    for (int i = 0; i < 16; i++) {
      bool anchor = (i == anchor_of[0]) || (i == anchor_of[1])
                    || (i == anchor_of[2]);
      bw.put(uint32_t(fidx[i]), anchor ? idx_bits - 1 : idx_bits);
    }
  }
  return best_err;
}

// mode 4: 1 subset, RGB 5.5 + separate alpha 6.6, one 2-bit + one 3-bit
// index plane with idxMode choosing which plane drives color. `rpx` is the
// block AFTER channel rotation (the caller swapped the rotated channel into
// the alpha plane; squared error is rotation-invariant).
double encode_mode4(const float rpx[16][4], int rot, int im, uint8_t* out) {
  const int* cw = im ? kWeights3 : kWeights2;  // color palette weights
  const int* aw = im ? kWeights2 : kWeights3;  // alpha palette weights
  int cn = im ? 8 : 4, an = im ? 4 : 8;
  int q0[4], q1[4], cidx[16];
  double cerr = fit_subset(rpx, nullptr, 0, 5, 0, 0, 0, cw, cn, 3,
                           q0, q1, cidx);
  float pa[16][4];
  for (int i = 0; i < 16; i++) pa[i][0] = rpx[i][3];
  int qa0[4], qa1[4], aidx[16];
  double aerr = fit_subset(pa, nullptr, 0, 6, 0, 0, 0, aw, an, 1,
                           qa0, qa1, aidx);
  int a0 = qa0[0], a1 = qa1[0];
  // anchor rule per index plane (texel 0 anchors both)
  if (cidx[0] >= cn / 2) {
    for (int c = 0; c < 3; c++) std::swap(q0[c], q1[c]);
    for (int i = 0; i < 16; i++) cidx[i] = (cn - 1) - cidx[i];
  }
  if (aidx[0] >= an / 2) {
    std::swap(a0, a1);
    for (int i = 0; i < 16; i++) aidx[i] = (an - 1) - aidx[i];
  }
  BitWriter bw(out);
  bw.put(1u << 4, 5);  // mode 4
  bw.put(uint32_t(rot), 2);
  bw.put(uint32_t(im), 1);
  for (int c = 0; c < 3; c++) {
    bw.put(uint32_t(q0[c]), 5);
    bw.put(uint32_t(q1[c]), 5);
  }
  bw.put(uint32_t(a0), 6);
  bw.put(uint32_t(a1), 6);
  // stored plane 0 is ALWAYS the 2-bit one, plane 1 the 3-bit one; idxMode
  // says which payload (color/alpha) each carries
  const int* p2 = im ? aidx : cidx;
  const int* p3 = im ? cidx : aidx;
  bw.put(uint32_t(p2[0]), 1);
  for (int i = 1; i < 16; i++) bw.put(uint32_t(p2[i]), 2);
  bw.put(uint32_t(p3[0]), 2);
  for (int i = 1; i < 16; i++) bw.put(uint32_t(p3[i]), 3);
  return cerr + aerr;
}

// mode 5: 1 subset, RGB 7.7 + separate alpha 8.8 plane, 2-bit color
// indices + 2-bit alpha indices. `rpx` is the rotated block like mode 4.
double encode_mode5(const float rpx[16][4], int rot, uint8_t* out) {
  const float (*px)[4] = rpx;
  int q0[4], q1[4], cidx[16];
  double cerr = fit_subset(px, nullptr, 0, 7, 0, 0, 0, kWeights2, 4, 3,
                           q0, q1, cidx);
  // alpha plane: its own 8.8 line (fit_subset on the alpha as channel 0)
  float pa[16][4];
  for (int i = 0; i < 16; i++) pa[i][0] = px[i][3];
  int qa0[4], qa1[4], aidx[16];
  double aerr = fit_subset(pa, nullptr, 0, 8, 0, 0, 0, kWeights2, 4, 1,
                           qa0, qa1, aidx);
  int a0 = qa0[0], a1 = qa1[0];
  // anchor rule, separately per index plane (texel 0 anchors both)
  if (cidx[0] >= 2) {
    for (int c = 0; c < 3; c++) std::swap(q0[c], q1[c]);
    for (int i = 0; i < 16; i++) cidx[i] = 3 - cidx[i];
  }
  if (aidx[0] >= 2) {
    std::swap(a0, a1);
    for (int i = 0; i < 16; i++) aidx[i] = 3 - aidx[i];
  }
  BitWriter bw(out);
  bw.put(1u << 5, 6);  // mode 5
  bw.put(uint32_t(rot), 2);
  for (int c = 0; c < 3; c++) {
    bw.put(uint32_t(q0[c]), 7);
    bw.put(uint32_t(q1[c]), 7);
  }
  bw.put(uint32_t(a0), 8);
  bw.put(uint32_t(a1), 8);
  bw.put(uint32_t(cidx[0]), 1);
  for (int i = 1; i < 16; i++) bw.put(uint32_t(cidx[i]), 2);
  bw.put(uint32_t(aidx[0]), 1);
  for (int i = 1; i < 16; i++) bw.put(uint32_t(aidx[i]), 2);
  return cerr + aerr;
}

// mode 7: 2 subsets, RGBA 5.5.5.5 + per-endpoint p-bit, 2-bit indices
double encode_mode7(const float px[16][4], const uint8_t* parts,
                    const uint8_t* anchors, uint8_t* out) {
  int cand[8];
  rank_partitions(px, parts, 4, 8, cand);
  double best_err = 1e30;
  for (int k = 0; k < 8; k++) {
    int pi = cand[k];
    const uint8_t* mask = parts + pi * 16;
    int q[2][2][4], pb[2][2], idx[16];
    double perr = 0;
    for (int s = 0; s < 2; s++) {
      double sbest = 1e30;
      for (int pc = 0; pc < 4; pc++) {
        int p0 = pc & 1, p1 = pc >> 1;
        int q0[4], q1[4], sidx[16];
        double e = fit_subset(px, mask, s, 5, p0, p1, 1, kWeights2, 4, 4,
                              q0, q1, sidx);
        if (e < sbest) {
          sbest = e;
          pb[s][0] = p0;
          pb[s][1] = p1;
          for (int c = 0; c < 4; c++) { q[s][0][c] = q0[c]; q[s][1][c] = q1[c]; }
          for (int i = 0; i < 16; i++)
            if (mask[i] == s) idx[i] = sidx[i];
        }
      }
      perr += sbest;
    }
    if (perr >= best_err) continue;
    best_err = perr;
    int anchor_of[2] = {0, anchors[pi]};
    int qq[2][2][4], pp[2][2], fidx[16];
    std::memcpy(qq, q, sizeof(q));
    std::memcpy(pp, pb, sizeof(pb));
    std::memcpy(fidx, idx, sizeof(idx));
    for (int s = 0; s < 2; s++) {
      if (fidx[anchor_of[s]] >= 2) {
        for (int c = 0; c < 4; c++) std::swap(qq[s][0][c], qq[s][1][c]);
        std::swap(pp[s][0], pp[s][1]);
        for (int i = 0; i < 16; i++)
          if (mask[i] == s) fidx[i] = 3 - fidx[i];
      }
    }
    BitWriter bw(out);
    bw.put(1u << 7, 8);  // mode 7
    bw.put(uint32_t(pi), 6);
    for (int c = 0; c < 4; c++)
      for (int s = 0; s < 2; s++)
        for (int e = 0; e < 2; e++) bw.put(uint32_t(qq[s][e][c]), 5);
    for (int s = 0; s < 2; s++)
      for (int e = 0; e < 2; e++) bw.put(uint32_t(pp[s][e]), 1);
    for (int i = 0; i < 16; i++) {
      bool anchor = (i == 0) || (i == anchor_of[1]);
      bw.put(uint32_t(fidx[i]), anchor ? 1 : 2);
    }
  }
  return best_err;
}

// alpha-aware all-8-mode dispatch (the make-ntex slow-settings analog):
// opaque blocks try 6/1/3/0/2, alpha blocks 6/5/4 (×4 rotations)/7
void encode_block_multi(const float px[16][4], const uint8_t* parts,
                        const uint8_t* anchors, const uint8_t* parts3,
                        const uint8_t* anchors32, const uint8_t* anchors33,
                        uint8_t* out) {
  double err = encode_block_mode6(px, out);
  bool opaque = true;
  for (int i = 0; i < 16; i++) opaque &= (px[i][3] >= 254.5f);
  uint8_t tmp[16];
  auto keep = [&](double e) {
    if (e < err) { std::memcpy(out, tmp, 16); err = e; }
  };
  if (opaque) {
    keep(encode_mode1(px, parts, anchors, tmp));
    keep(encode_mode3(px, parts, anchors, tmp));
    keep(encode_mode0or2(px, 0, parts3, anchors32, anchors33, tmp));
    keep(encode_mode0or2(px, 2, parts3, anchors32, anchors33, tmp));
  } else {
    for (int rot = 0; rot < 4; rot++) {
      // rotation r swaps channel r-1 with alpha BEFORE encoding (the
      // decoder swaps back after); squared error is permutation-invariant
      float rpx[16][4];
      std::memcpy(rpx, px, sizeof(rpx));
      if (rot) {
        for (int i = 0; i < 16; i++) std::swap(rpx[i][rot - 1], rpx[i][3]);
      }
      keep(encode_mode5(rpx, rot, tmp));
      keep(encode_mode4(rpx, rot, 0, tmp));
      keep(encode_mode4(rpx, rot, 1, tmp));
    }
    keep(encode_mode7(px, parts, anchors, tmp));
  }
}

}  // namespace

extern "C" {

// rgba: [h, w, 4] u8 (any w/h; edge blocks are clamped-extended).
// out: ceil(w/4)*ceil(h/4) 16-byte blocks, row-major block order.
void bc7_encode_mode6(const uint8_t* rgba, int w, int h, uint8_t* out) {
  int bw_ = (w + 3) / 4, bh = (h + 3) / 4;
  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw_; bx++) {
      float px[16][4];
      for (int i = 0; i < 16; i++) {
        int x = std::min(bx * 4 + (i & 3), w - 1);
        int y = std::min(by * 4 + (i >> 2), h - 1);
        const uint8_t* p = rgba + (size_t(y) * w + x) * 4;
        for (int c = 0; c < 4; c++) px[i][c] = float(p[c]);
      }
      encode_block_mode6(px, out + (size_t(by) * bw_ + bx) * 16);
    }
  }
}

// Multi-mode encode (all 8 modes, alpha-aware per-block selection).
// partition2: [64*16] u8 subset ids; anchor2: [64] u8 subset-1 anchor
// texels; partition3: [64*16] u8 3-subset ids; anchor3_2/anchor3_3: [64] u8
// subset-1/subset-2 anchors — passed in from
// renderer_tpu/materials/bc7_tables.py (the repo's single, empirically-
// recovered table source).
void bc7_encode(const uint8_t* rgba, int w, int h, const uint8_t* partition2,
                const uint8_t* anchor2, const uint8_t* partition3,
                const uint8_t* anchor3_2, const uint8_t* anchor3_3,
                uint8_t* out) {
  int bw_ = (w + 3) / 4, bh = (h + 3) / 4;
  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw_; bx++) {
      float px[16][4];
      for (int i = 0; i < 16; i++) {
        int x = std::min(bx * 4 + (i & 3), w - 1);
        int y = std::min(by * 4 + (i >> 2), h - 1);
        const uint8_t* p = rgba + (size_t(y) * w + x) * 4;
        for (int c = 0; c < 4; c++) px[i][c] = float(p[c]);
      }
      encode_block_multi(px, partition2, anchor2, partition3, anchor3_2,
                         anchor3_3, out + (size_t(by) * bw_ + bx) * 16);
    }
  }
}

}  // extern "C"
