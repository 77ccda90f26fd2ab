// Extension-job construction from filtered chains ("chain2aln"), written
// from scratch for the bwamem_tpu host runtime.
//
// Role in the framework: the host half of mem_chain2aln (reference:
// src/bwamem.c:1170-1479): per chain, compute the reference window
// (rmax with cal_max_gap slack, strand- and contig-clipped), process
// seeds best-first with the fork's estimated-extent contained-seed test
// (FILTER_COEF = 0.85, src/bwamem.c:52,1284-1298), and emit one
// alignment region per surviving seed plus left/right extension jobs
// (left inputs reversed, reference :1324-1341). Semantics mirror
// pipeline/aligner.py:chain2aln_jobs (the tested reference-parity port);
// a differential test keeps the two identical at the SAM level.
//
// This is the fast path used when the per-seed SW/SHD filter is inactive
// (short reads, no -F) — seed scores are then always seed lengths.
//
// Interface (ctypes): consumes bm_chain_batch outputs directly. Query and
// target job sequences are written to flat byte streams; the Python side
// pads them into bucketed device batches without touching per-job data.

#include <algorithm>
#include <cstring>
#include <cstdint>
#include <vector>

namespace {

inline int32_t base_at_fwd(const uint32_t* pac, int64_t p) {
  return (int32_t)((pac[p >> 4] >> (30 - 2 * (p & 15))) & 3);
}

// doubled-coordinate base (reverse strand complemented)
inline uint8_t base_at(const uint32_t* pac, int64_t l_pac, int64_t p) {
  if (p < l_pac) return (uint8_t)base_at_fwd(pac, p);
  return (uint8_t)(3 - base_at_fwd(pac, 2 * l_pac - 1 - p));
}

inline int64_t cal_max_gap(int32_t a, int32_t o_del, int32_t e_del,
                           int32_t o_ins, int32_t e_ins, int32_t w,
                           int64_t qlen) {
  int64_t l_del = (int64_t)((double)(qlen * a - o_del) / e_del + 1.0);
  int64_t l_ins = (int64_t)((double)(qlen * a - o_ins) / e_ins + 1.0);
  int64_t l = std::max<int64_t>(std::max(l_del, l_ins), 1);
  return std::min<int64_t>(l, (int64_t)w << 1);
}

struct Reg {
  int64_t rb_est, re_est, rseed;
  int32_t qb_est, qe_est, seedlen0, qseed, w;
};

}  // namespace

extern "C" int64_t bm_chain2aln_batch(
    // chain table (from bm_chain_batch), chains grouped by read ascending
    const int32_t* c_read, const int32_t* c_rid, const double* c_frac,
    const int64_t* c_soff, const int32_t* c_ns, int64_t n_chains,
    // kept-seed arrays (from bm_chain_batch); s_score == s_len unless a
    // per-seed filter re-scored short seeds (mem_seed_sw, reference
    // src/bwamem.c:774-807 — only the extension ORDER depends on it)
    const int64_t* s_rbeg, const int32_t* s_qbeg, const int32_t* s_len,
    const int32_t* s_score,
    // reads
    const uint8_t* reads, int64_t read_stride, const int32_t* l_query,
    // reference
    const uint32_t* pac, int64_t l_pac, const int64_t* ann_off,
    const int8_t* ann_alt, int64_t n_ann,
    // options
    int32_t a, int32_t w, int32_t o_del, int32_t e_del, int32_t o_ins,
    int32_t e_ins,
    // outputs: regs
    int32_t* r_read, int32_t* r_rid, int8_t* r_is_alt, double* r_frac,
    int32_t* r_seedlen0, int32_t* r_qseed, int64_t* r_rseed,
    int8_t* r_sides, int64_t* r_chain_soff, int32_t* r_chain_ns,
    int32_t* r_score0, int32_t* r_qb0, int32_t* r_qe0, int64_t* r_rb0,
    int64_t* r_re0, int32_t* r_seedcov0, int64_t reg_cap,
    // outputs: jobs + streams. Descriptor arrays (j_read/j_qstart/
    // j_tstart/j_dir) let the DEVICE gather job sequences itself: query
    // base i = read[j_read][j_qstart + j_dir*i], target base i =
    // pac_doubled[j_tstart + j_dir*i] — so only ~20 bytes/job ride the
    // host->device link instead of materialized Q/T tiles.
    int64_t* j_reg, int8_t* j_side, int32_t* j_h0, int32_t* j_qlen,
    int32_t* j_tlen, int64_t* j_qoff, int64_t* j_toff,
    int32_t* j_read, int32_t* j_qstart, int64_t* j_tstart, int8_t* j_dir,
    int64_t job_cap,
    uint8_t* qstream, int64_t qstream_cap, uint8_t* tstream,
    int64_t tstream_cap,
    int64_t* out_counts /* [n_regs, n_jobs, q_bytes, t_bytes, overflow] */) {
  const double FILTER_COEF = 0.85;  // reference: src/bwamem.c:52
  int64_t n_regs = 0, n_jobs = 0, q_bytes = 0, t_bytes = 0;
  bool overflow = false;

  std::vector<Reg> read_regs;  // regs of the CURRENT read (est extents)
  std::vector<uint8_t> window;
  std::vector<int64_t> srt;
  std::vector<uint8_t> skipped;
  int32_t cur_read = -1;

  for (int64_t ci = 0; ci < n_chains && !overflow; ++ci) {
    int32_t rd = c_read[ci];
    if (rd != cur_read) {
      cur_read = rd;
      read_regs.clear();
    }
    int64_t soff = c_soff[ci];
    int32_t ns = c_ns[ci];
    if (ns <= 0) continue;
    int64_t lq = l_query[rd];
    const uint8_t* q = reads + (int64_t)rd * read_stride;

    // chain-wide reference window (reference: src/bwamem.c:1180-1201)
    int64_t rmax0 = l_pac << 1, rmax1 = 0;
    for (int32_t t = 0; t < ns; ++t) {
      int64_t rb = s_rbeg[soff + t];
      int64_t qb = s_qbeg[soff + t];
      int64_t ln = s_len[soff + t];
      int64_t b =
          rb - (qb + cal_max_gap(a, o_del, e_del, o_ins, e_ins, w, qb));
      int64_t e = rb + ln + (lq - qb - ln) +
                  cal_max_gap(a, o_del, e_del, o_ins, e_ins, w,
                              lq - qb - ln);
      rmax0 = std::min(rmax0, b);
      rmax1 = std::max(rmax1, e);
    }
    rmax0 = std::max<int64_t>(rmax0, 0);
    rmax1 = std::min<int64_t>(rmax1, l_pac << 1);
    if (rmax0 < l_pac && l_pac < rmax1) {
      if (s_rbeg[soff] < l_pac)
        rmax1 = l_pac;
      else
        rmax0 = l_pac;
    }
    // fetch_seq_rid clipping to the contig of mid = first seed rbeg
    {
      int64_t mid = s_rbeg[soff];
      bool is_rev = mid >= l_pac;
      int64_t fpos = is_rev ? (l_pac << 1) - 1 - mid : mid;
      // pos2rid
      int64_t lo = 0, hi = n_ann;
      while (hi - lo > 1) {
        int64_t m = (lo + hi) >> 1;
        if (ann_off[m] <= fpos)
          lo = m;
        else
          hi = m;
      }
      int64_t far_beg = ann_off[lo];
      int64_t far_end = lo + 1 < n_ann ? ann_off[lo + 1] : l_pac;
      if (is_rev) {
        int64_t fb = (l_pac << 1) - far_end;
        int64_t fe = (l_pac << 1) - far_beg;
        far_beg = fb;
        far_end = fe;
      }
      rmax0 = std::max(rmax0, far_beg);
      rmax1 = std::min(rmax1, far_end);
      // strand clip relative to mid (fetch_seq)
      if (mid < l_pac)
        rmax1 = std::min(rmax1, l_pac);
      else
        rmax0 = std::max(rmax0, l_pac);
    }
    if (rmax1 <= rmax0) continue;
    int64_t wlen = rmax1 - rmax0;
    window.resize(wlen);
    for (int64_t p = 0; p < wlen; ++p)
      window[p] = base_at(pac, l_pac, rmax0 + p);

    // seeds best-score-first (ties: later index first — reference sorts
    // ascending and walks from the back)
    srt.resize(ns);
    for (int32_t t = 0; t < ns; ++t) srt[t] = t;
    std::stable_sort(srt.begin(), srt.end(), [&](int64_t x, int64_t y) {
      return s_score[soff + x] < s_score[soff + y];
    });
    skipped.assign(ns, 0);

    for (int64_t k = ns - 1; k >= 0 && !overflow; --k) {
      int64_t si = soff + srt[k];
      int64_t s_rb = s_rbeg[si];
      int64_t s_qb = s_qbeg[si];
      int64_t s_ln = s_len[si];
      // contained-in-existing test on estimated extents
      int64_t hit = -1;
      for (size_t pi = 0; pi < read_regs.size(); ++pi) {
        const Reg& p = read_regs[pi];
        if (s_rb < p.rb_est || s_rb + s_ln > p.re_est ||
            s_qb < p.qb_est || s_qb + s_ln > p.qe_est)
          continue;
        if (s_ln - p.seedlen0 > 0.1 * lq) continue;
        int64_t qd = s_qb - p.qb_est, rdist = s_rb - p.rb_est;
        int64_t ww = std::min(
            cal_max_gap(a, o_del, e_del, o_ins, e_ins, w,
                        std::min(qd, rdist)),
            (int64_t)p.w);
        if (qd - rdist < ww && rdist - qd < ww) {
          hit = (int64_t)pi;
          break;
        }
        qd = p.qe_est - (s_qb + s_ln);
        rdist = p.re_est - (s_rb + s_ln);
        ww = std::min(cal_max_gap(a, o_del, e_del, o_ins, e_ins, w,
                                  std::min(qd, rdist)),
                      (int64_t)p.w);
        if (qd - rdist < ww && rdist - qd < ww) {
          hit = (int64_t)pi;
          break;
        }
      }
      if (hit >= 0) {
        bool disagree = false;
        for (int64_t i2 = k + 1; i2 < ns; ++i2) {
          if (skipped[srt[i2]]) continue;
          int64_t ti = soff + srt[i2];
          int64_t t_qb = s_qbeg[ti], t_rb = s_rbeg[ti], t_ln = s_len[ti];
          if (t_ln < s_ln * 0.95) continue;
          if (s_qb <= t_qb && s_qb + s_ln - t_qb >= (s_ln >> 2) &&
              t_qb - s_qb != t_rb - s_rb) {
            disagree = true;
            break;
          }
          if (t_qb <= s_qb && t_qb + t_ln - s_qb >= (s_ln >> 2) &&
              s_qb - t_qb != s_rb - t_rb) {
            disagree = true;
            break;
          }
        }
        if (!disagree) {
          skipped[srt[k]] = 1;
          continue;
        }
      }

      if (n_regs >= reg_cap) {
        overflow = true;
        break;
      }
      Reg reg;
      int64_t fwd = (int64_t)(FILTER_COEF * (double)(lq - (s_qb + s_ln)));
      reg.qe_est = (int32_t)std::min<int64_t>(s_qb + s_ln + fwd, lq);
      reg.re_est = std::min<int64_t>(s_rb + s_ln + fwd, l_pac << 1);
      int64_t back = (int64_t)(FILTER_COEF * (double)(s_qb + 1));
      reg.qb_est = (int32_t)std::max<int64_t>(s_qb - back, 0);
      reg.rb_est = std::max<int64_t>(s_rb - back, 0);
      if (reg.rb_est < l_pac && l_pac < reg.re_est) {
        if (s_rb < l_pac)
          reg.re_est = l_pac;
        else
          reg.rb_est = l_pac;
      }
      reg.seedlen0 = (int32_t)s_ln;
      reg.qseed = (int32_t)s_qb;
      reg.rseed = s_rb;
      reg.w = w;
      read_regs.push_back(reg);

      int64_t lql = s_qb;
      int64_t lrl = s_rb - rmax0;
      int64_t rql = lq - (lql + s_ln);
      int64_t rrl = wlen - (lrl + s_ln);
      int32_t h0 = (int32_t)(s_ln * a);
      int8_t sides = 0;
      if (lql > 0) {  // LEFT: reversed copies
        if (n_jobs >= job_cap || q_bytes + lql > qstream_cap ||
            t_bytes + lrl > tstream_cap) {
          overflow = true;
          break;
        }
        j_reg[n_jobs] = n_regs;
        j_side[n_jobs] = 0;
        j_h0[n_jobs] = h0;
        j_qlen[n_jobs] = (int32_t)lql;
        j_tlen[n_jobs] = (int32_t)lrl;
        j_qoff[n_jobs] = q_bytes;
        j_toff[n_jobs] = t_bytes;
        j_read[n_jobs] = rd;
        j_qstart[n_jobs] = (int32_t)(lql - 1);     // reversed walk left
        j_tstart[n_jobs] = rmax0 + lrl - 1;
        j_dir[n_jobs] = -1;
        for (int64_t t = 0; t < lql; ++t)
          qstream[q_bytes + t] = q[lql - 1 - t];
        for (int64_t t = 0; t < lrl; ++t)
          tstream[t_bytes + t] = window[lrl - 1 - t];
        q_bytes += lql;
        t_bytes += lrl;
        ++n_jobs;
        ++sides;
      }
      if (rql > 0) {  // RIGHT
        if (n_jobs >= job_cap || q_bytes + rql > qstream_cap ||
            t_bytes + rrl > tstream_cap) {
          overflow = true;
          break;
        }
        j_reg[n_jobs] = n_regs;
        j_side[n_jobs] = 1;
        j_h0[n_jobs] = h0;
        j_qlen[n_jobs] = (int32_t)rql;
        j_tlen[n_jobs] = (int32_t)rrl;
        j_qoff[n_jobs] = q_bytes;
        j_toff[n_jobs] = t_bytes;
        j_read[n_jobs] = rd;
        j_qstart[n_jobs] = (int32_t)(lql + s_ln);
        j_tstart[n_jobs] = rmax0 + lrl + s_ln;
        j_dir[n_jobs] = 1;
        for (int64_t t = 0; t < rql; ++t)
          qstream[q_bytes + t] = q[lql + s_ln + t];
        for (int64_t t = 0; t < rrl; ++t)
          tstream[t_bytes + t] = window[lrl + s_ln + t];
        q_bytes += rql;
        t_bytes += rrl;
        ++n_jobs;
        ++sides;
      }

      r_read[n_regs] = rd;
      r_rid[n_regs] = c_rid[ci];
      r_is_alt[n_regs] = ann_alt ? ann_alt[c_rid[ci]] : 0;
      r_frac[n_regs] = c_frac[ci];
      r_seedlen0[n_regs] = (int32_t)s_ln;
      r_qseed[n_regs] = (int32_t)s_qb;
      r_rseed[n_regs] = s_rb;
      r_sides[n_regs] = sides;
      r_chain_soff[n_regs] = soff;
      r_chain_ns[n_regs] = ns;
      if (sides == 0) {  // seed spans the whole read
        r_score0[n_regs] = (int32_t)(s_ln * a);
        r_qb0[n_regs] = 0;
        r_qe0[n_regs] = (int32_t)lq;
        r_rb0[n_regs] = s_rb;
        r_re0[n_regs] = s_rb + s_ln;
        int32_t cov = 0;
        for (int32_t t = 0; t < ns; ++t) {
          int64_t tq = s_qbeg[soff + t], tr = s_rbeg[soff + t],
                  tl = s_len[soff + t];
          if (tq >= 0 && tq + tl <= lq && tr >= s_rb && tr + tl <= s_rb + s_ln)
            cov += (int32_t)tl;
        }
        r_seedcov0[n_regs] = cov;
      } else {
        r_score0[n_regs] = -1;
      }
      ++n_regs;
    }
  }
  out_counts[0] = n_regs;
  out_counts[1] = n_jobs;
  out_counts[2] = q_bytes;
  out_counts[3] = t_bytes;
  out_counts[4] = overflow ? 1 : 0;
  return 0;
}

// Scatter var-length job sequences into a padded (N, MAX) int32 batch.
extern "C" void bm_scatter_jobs(const uint8_t* stream, const int64_t* offs,
                                const int32_t* lens, const int64_t* sel,
                                int64_t n_sel, int8_t* out, int64_t max_len,
                                int8_t fill) {
  for (int64_t i = 0; i < n_sel; ++i) {
    int64_t j = sel[i];
    int8_t* row = out + i * max_len;
    int32_t ln = lens[j];
    const uint8_t* src = stream + offs[j];
    memcpy(row, src, (size_t)ln);
    memset(row + ln, fill, (size_t)(max_len - ln));
  }
}
