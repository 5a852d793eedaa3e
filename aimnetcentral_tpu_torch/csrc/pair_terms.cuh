// The pair terms of kernels D and E (csrc/pair_fwd.cu, csrc/pair_bwd.cu).
//
// A term is e_ij = c_ij g(d, s_i, s_j): kScalars scalar extras s per atom
// and, for a bilinear term, c_ij = p_i . r_j (computed by the kernels).  Each
// functor gives g and its hand derivatives (g, dg/dd, dg/ds_i, dg/ds_j), the
// same formulas as the plain versions' g_grad in kernels/pair_sweep.py, which
// the CPU tests hold to torch.autograd.  A functor of one scalar takes floats;
// one of several takes arrays and gives only the receiver's dg/ds_i (the
// walk meets every pair from both ends, so dg/ds_j is never read).  Only
// valid pairs (both atoms real, not the self pair, d < cutoff) reach a
// functor, so no guard is needed here for the padding atom's zero extras.
//
// Constants (TermConsts.c): c[0] is the cutoff, c[1..] the term's own, in
// the order of the term's consts() in kernels/pair_sweep.py.  The member
// forms of five of these terms, one output per ensemble member, follow at
// the end.
#pragma once

#include <cuda_runtime.h>

struct TermConsts {
  float c[8];
};

namespace pair_terms {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kXmax = 0.999999f;  // the exp envelope's clamp, 1 - 1e-6
constexpr float kInvE = 0.36787944117144233f;

// Abramowitz & Stegun 7.1.26 (ops/math.py::erfc_approx) and its derivative
// as a function of x: the rational form itself, not the exact erfc.
__device__ inline void erfc_as(float x, float& f, float& df) {
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  const float q =
      0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f)));
  const float dq = -0.284496736f + t * (2.0f * 1.421413741f + t * (3.0f * -1.453152027f +
                                                                 t * 4.0f * 1.061405429f));
  const float ex = expf(-x * x);
  f = t * q * ex;
  df = (q + t * dq) * (-0.3275911f * t * t) * ex - 2.0f * x * f;
}

// The SR envelope fc(d) of the Coulomb terms and its derivative: env 1 the
// exp mollifier (zero from rc on, through its clamp), 2 the cosine cutoff
// (zero from rc on), 0 none (fc = 0).
__device__ inline void envelope(int env, float rc, float d, float& fc, float& dfc) {
  fc = 0.0f;
  dfc = 0.0f;
  if (env == 1) {
    const float xr = d / rc;
    const float x = fminf(fmaxf(xr, 0.0f), kXmax);
    const float den = 1.0f - x * x;
    fc = expf(-1.0f / den) / kInvE;
    dfc = (xr >= 0.0f && xr <= kXmax) ? fc * (-2.0f * x / (den * den)) / rc : 0.0f;
  } else if (env == 2 && d < rc) {
    const float arg = fminf(fmaxf(d, 1e-6f), rc) * (kPi / rc);
    fc = 0.5f * (cosf(arg) + 1.0f);
    dfc = (d >= 1e-6f) ? -0.5f * sinf(arg) * (kPi / rc) : 0.0f;
  }
}

// DSF Coulomb: g = q_i q_j h(d), h = erfc(a d)/d - shift_val
// + (d - dsf_rc) shift_slope - fc(d)/d (the SR envelope, env 1 = exp,
// 2 = cosine, 0 = not subtracted).
// c = [cutoff, alpha, shift_val, shift_slope, dsf_rc, rc, env]
struct DsfTerm {
  static constexpr bool kBilinear = false;
  static constexpr int kScalars = 1;

  __device__ static void h(const TermConsts& k, float d, float& hv, float& dh) {
    const float a = k.c[1];
    float ea, dea;
    erfc_as(a * d, ea, dea);
    const float inv_d = 1.0f / d;
    hv = ea * inv_d - k.c[2] + (d - k.c[4]) * k.c[3];
    dh = a * dea * inv_d - ea * inv_d * inv_d + k.c[3];
    float fc, dfc;
    envelope(int(k.c[6]), k.c[5], d, fc, dfc);
    hv -= fc * inv_d;
    dh -= dfc * inv_d - fc * inv_d * inv_d;
  }

  __device__ static float g(const TermConsts& k, float d, float si, float sj) {
    float hv, dh;
    h(k, d, hv, dh);
    return si * sj * hv;
  }

  __device__ static void grad(const TermConsts& k, float d, float si, float sj, float& g,
                              float& gd, float& gsi, float& gsj) {
    float hv, dh;
    h(k, d, hv, dh);
    g = si * sj * hv;
    gd = si * sj * dh;
    gsi = sj * hv;
    gsj = si * hv;
  }
};

// Simple (unbounded) Coulomb: g = q_i q_j h(d), h = 1/d - fc(d)/d with the
// SR envelope (env 0: 1/d alone).  Swept at cutoff inf on the molecule-bin
// layout (radius 0): every pair of a molecule.  c = [cutoff, rc, env]
struct CoulombSimpleTerm {
  static constexpr bool kBilinear = false;
  static constexpr int kScalars = 1;

  __device__ static void h(const TermConsts& k, float d, float& hv, float& dh) {
    float fc, dfc;
    envelope(int(k.c[2]), k.c[1], d, fc, dfc);
    const float inv_d = 1.0f / d;
    hv = inv_d - fc * inv_d;
    dh = -inv_d * inv_d - (dfc * inv_d - fc * inv_d * inv_d);
  }

  __device__ static float g(const TermConsts& k, float d, float si, float sj) {
    float hv, dh;
    h(k, d, hv, dh);
    return si * sj * hv;
  }

  __device__ static void grad(const TermConsts& k, float d, float si, float sj, float& g,
                              float& gd, float& gsi, float& gsj) {
    float hv, dh;
    h(k, d, hv, dh);
    g = si * sj * hv;
    gd = si * sj * dh;
    gsi = sj * hv;
    gsj = si * hv;
  }
};

// The SR envelope of `envelope` in double, for a term that runs in double.
__device__ inline void envelope64(int env, double rc, double d, double& fc, double& dfc) {
  fc = 0.0;
  dfc = 0.0;
  if (env == 1) {
    const double xr = d / rc;
    const double x = fmin(fmax(xr, 0.0), 1.0 - 1e-6);
    const double den = 1.0 - x * x;
    fc = exp(-1.0 / den) / 0.36787944117144233;
    dfc = (xr >= 0.0 && xr <= 1.0 - 1e-6) ? fc * (-2.0 * x / (den * den)) / rc : 0.0;
  } else if (env == 2 && d < rc) {
    const double arg = fmin(fmax(d, 1e-6), rc) * (3.14159265358979323846 / rc);
    fc = 0.5 * (cos(arg) + 1.0);
    dfc = (d >= 1e-6) ? -0.5 * sin(arg) * (3.14159265358979323846 / rc) : 0.0;
  }
}

// Short-range Coulomb (the SRCoulomb head of v2 artifacts, which subtracts
// it): g = q_i q_j fc(d)/d with the SR envelope (env 1 exp, 2 cosine), swept
// at cutoff rc.  It computes in double from the walk's float distance and
// rounds its four results to float once each.  c = [cutoff, rc, env]
struct CoulombSRTerm {
  static constexpr bool kBilinear = false;
  static constexpr int kScalars = 1;

  __device__ static void h(const TermConsts& k, float d, double& hv, double& dh) {
    double fc, dfc;
    envelope64(int(k.c[2]), double(k.c[1]), double(d), fc, dfc);
    const double inv_d = 1.0 / double(d);
    hv = fc * inv_d;
    dh = dfc * inv_d - fc * inv_d * inv_d;
  }

  __device__ static float g(const TermConsts& k, float d, float si, float sj) {
    double hv, dh;
    h(k, d, hv, dh);
    return float(double(si) * double(sj) * hv);
  }

  __device__ static void grad(const TermConsts& k, float d, float si, float sj, float& g,
                              float& gd, float& gsi, float& gsj) {
    double hv, dh;
    h(k, d, hv, dh);
    g = float(double(si) * double(sj) * hv);
    gd = float(double(si) * double(sj) * dh);
    gsi = float(double(sj) * hv);
    gsj = float(double(si) * hv);
  }
};

// D3 coordination number: g = sigmoid(16 ((rcov_i + rcov_j) / d_b - 1)),
// d_b = max(d / Bohr, 1e-12).  c = [cutoff, 1/Bohr]
struct D3CnTerm {
  static constexpr bool kBilinear = false;
  static constexpr int kScalars = 1;

  __device__ static float g(const TermConsts& k, float d, float si, float sj) {
    const float db = fmaxf(d * k.c[1], 1e-12f);
    return 1.0f / (1.0f + expf(-16.0f * ((si + sj) / db - 1.0f)));
  }

  __device__ static void grad(const TermConsts& k, float d, float si, float sj, float& g,
                              float& gd, float& gsi, float& gsj) {
    const float dr = d * k.c[1];
    const float db = fmaxf(dr, 1e-12f);
    const float rsum = si + sj;
    g = 1.0f / (1.0f + expf(-16.0f * (rsum / db - 1.0f)));
    const float kk = g * (1.0f - g) * 16.0f;
    gd = dr >= 1e-12f ? -kk * rsum / (db * db) * k.c[1] : 0.0f;
    gsi = gsj = kk / db;
  }
};

// Becke-Johnson damping s6/(d^6 + r0^6) + s8 rr/(d^8 + r0^8) with
// r0 = a1 sqrt(rr) + a2 (d in Bohr) and its derivatives in d and rr.
__device__ inline void bj_damping(float db, float rr, float a1, float a2, float s6, float s8,
                                  float& damp, float& ddamp_db, float& ddamp_drr) {
  const float sq = sqrtf(rr);
  const float r0 = a1 * sq + a2;
  const float d2 = db * db;
  const float d6 = d2 * d2 * d2;
  const float d8 = d6 * d2;
  const float r0_2 = r0 * r0;
  const float r0_6 = r0_2 * r0_2 * r0_2;
  const float r0_8 = r0_6 * r0_2;
  const float den6 = d6 + r0_6;
  const float den8 = d8 + r0_8;
  damp = s6 / den6 + s8 * rr / den8;
  ddamp_db = -6.0f * s6 * (d6 / db) / (den6 * den6) - 8.0f * s8 * rr * (d8 / db) / (den8 * den8);
  const float dr0 = a1 / (2.0f * sq);
  ddamp_drr = -6.0f * s6 * (r0_6 / r0) * dr0 / (den6 * den6) + s8 / den8 -
              8.0f * s8 * rr * (r0_8 / r0) * dr0 / (den8 * den8);
}

// D3(BJ) energy, scalar part: g = -damping(d_b, rr) switch(d_b) with
// rr = 3 s_i s_j, r0 = a1 sqrt(rr) + a2, damping = s6/(d^6 + r0^6)
// + s8 rr/(d^8 + r0^8) and the quintic S5 switch from r_on to r_off (Bohr);
// e = (p_i . r_j) g.  c = [cutoff, a1, a2, s8, s6, r_on, r_off, 1/Bohr]
struct D3EnergyTerm {
  static constexpr bool kBilinear = true;
  static constexpr int kScalars = 1;

  __device__ static void parts(const TermConsts& k, float d, float si, float sj, float& damp,
                               float& ddamp_db, float& ddamp_drr, float& sw, float& dsw,
                               float& dr) {
    const float a1 = k.c[1], a2 = k.c[2], s8 = k.c[3], s6 = k.c[4];
    const float r_on = k.c[5], r_off = k.c[6];
    dr = d * k.c[7];
    const float db = fmaxf(dr, 1e-12f);
    bj_damping(db, 3.0f * si * sj, a1, a2, s6, s8, damp, ddamp_db, ddamp_drr);
    sw = 1.0f;
    dsw = 0.0f;
    if (r_off > r_on && db > r_on) {
      const float tr = (db - r_on) / (r_off - r_on);
      const float t = fminf(fmaxf(tr, 0.0f), 1.0f);
      const float t2 = t * t;
      const float t3 = t2 * t;
      sw = 1.0f - (10.0f * t3 - 15.0f * t3 * t + 6.0f * t3 * t2);
      dsw = (tr >= 0.0f && tr <= 1.0f)
                ? -(30.0f * t2 - 60.0f * t3 + 30.0f * t3 * t) / (r_off - r_on)
                : 0.0f;
    }
  }

  __device__ static float g(const TermConsts& k, float d, float si, float sj) {
    float damp, ddb, ddrr, sw, dsw, dr;
    parts(k, d, si, sj, damp, ddb, ddrr, sw, dsw, dr);
    return -damp * sw;
  }

  __device__ static void grad(const TermConsts& k, float d, float si, float sj, float& g,
                              float& gd, float& gsi, float& gsj) {
    float damp, ddb, ddrr, sw, dsw, dr;
    parts(k, d, si, sj, damp, ddb, ddrr, sw, dsw, dr);
    g = -damp * sw;
    gd = dr >= 1e-12f ? -(ddb * sw + damp * dsw) * k.c[7] : 0.0f;
    const float drr = -sw * ddrr * 3.0f;
    gsi = drr * sj;
    gsj = drr * si;
  }
};

// Real-space Ewald: g = q_i q_j h(d), h = erfc(c d)/d - fc(d)/d with
// c = 1/(sqrt(2) eta), a launch constant, the rational erfc of erfc_as and
// the SR envelope the head subtracts (env 1 exp, 2 cosine, 0 none).
// c = [cutoff, c, rc, env]
struct EwaldRealTerm {
  static constexpr bool kBilinear = false;
  static constexpr int kScalars = 1;

  __device__ static void h(const TermConsts& k, float d, float& hv, float& dh) {
    float ea, dea;
    erfc_as(k.c[1] * d, ea, dea);
    const float inv_d = 1.0f / d;
    hv = ea * inv_d;
    dh = k.c[1] * dea * inv_d - ea * inv_d * inv_d;
    float fc, dfc;
    envelope(int(k.c[3]), k.c[2], d, fc, dfc);
    hv -= fc * inv_d;
    dh -= dfc * inv_d - fc * inv_d * inv_d;
  }

  __device__ static float g(const TermConsts& k, float d, float si, float sj) {
    float hv, dh;
    h(k, d, hv, dh);
    return si * sj * hv;
  }

  __device__ static void grad(const TermConsts& k, float d, float si, float sj, float& g,
                              float& gd, float& gsi, float& gsj) {
    float hv, dh;
    h(k, d, hv, dh);
    g = si * sj * hv;
    gd = si * sj * dh;
    gsi = sj * hv;
    gsj = si * hv;
  }
};

// GFN1 short-range repulsion: g = exp(-a_i a_j d^1.5) z_i z_j fc(d) / d with
// s = (alpha, zeff) and fc the optional cutoff at rc (code 0 none, 1 the exp
// mollifier, 2 the cosine cutoff; envelope()'s two).  c = [cutoff, rc, code]
struct SRRepTerm {
  static constexpr bool kBilinear = false;
  static constexpr int kScalars = 2;

  __device__ static void parts(const TermConsts& k, float d, const float* si, const float* sj,
                               float& h, float& dh, float& p) {
    const float a = si[0] * sj[0];
    const float sq = sqrtf(d);
    p = d * sq;  // d^1.5
    const float ex = expf(-a * p);
    float fc = 1.0f, dfc = 0.0f;
    const int code = int(k.c[2]);
    if (code != 0) envelope(code, k.c[1], d, fc, dfc);
    const float inv_d = 1.0f / d;
    h = ex * fc * inv_d;  // g / (z_i z_j)
    dh = ex * (-1.5f * a * sq * fc * inv_d + dfc * inv_d - fc * inv_d * inv_d);
  }

  __device__ static float g(const TermConsts& k, float d, const float* si, const float* sj) {
    float h, dh, p;
    parts(k, d, si, sj, h, dh, p);
    return si[1] * sj[1] * h;
  }

  __device__ static void grad(const TermConsts& k, float d, const float* si, const float* sj,
                              float& g, float& gd, float* gsi) {
    float h, dh, p;
    parts(k, d, si, sj, h, dh, p);
    const float z = si[1] * sj[1];
    g = z * h;
    gd = z * dh;
    gsi[0] = -sj[0] * p * g;
    gsi[1] = sj[1] * h;
  }
};

// D3 with the TS combination rule: g = -c6_ij damping(d_b, rr), no switch,
// with s = (c6, alpha, r4r2), c6_ij = 2 c6_i c6_j / max(den, 1e-4),
// den = c6_i a_j/a_i + c6_j a_i/a_j, rr = 3 r4r2_i r4r2_j and bj_damping.
// Its scalar adjoints carry the forces through the network's C6 and alpha.
// c = [cutoff, a1, a2, s8, s6, 1/Bohr]
struct D3TSTerm {
  static constexpr bool kBilinear = false;
  static constexpr int kScalars = 3;

  __device__ static float g(const TermConsts& k, float d, const float* si, const float* sj) {
    const float den = si[0] * sj[1] / si[1] + sj[0] * si[1] / sj[1];
    const float c6ij = 2.0f * si[0] * sj[0] / fmaxf(den, 1e-4f);
    float damp, ddb, ddrr;
    bj_damping(d * k.c[5], 3.0f * si[2] * sj[2], k.c[1], k.c[2], k.c[4], k.c[3], damp, ddb, ddrr);
    return -c6ij * damp;
  }

  __device__ static void grad(const TermConsts& k, float d, const float* si, const float* sj,
                              float& g, float& gd, float* gsi) {
    const float c6i = si[0], ai = si[1], c6j = sj[0], aj = sj[1];
    const float den = c6i * aj / ai + c6j * ai / aj;
    const bool on = den >= 1e-4f;  // where the clamp passes the gradient
    const float cl = fmaxf(den, 1e-4f);
    const float c6ij = 2.0f * c6i * c6j / cl;
    float damp, ddb, ddrr;
    bj_damping(d * k.c[5], 3.0f * si[2] * sj[2], k.c[1], k.c[2], k.c[4], k.c[3], damp, ddb, ddrr);
    g = -c6ij * damp;
    gd = -c6ij * ddb * k.c[5];
    const float kk = c6ij / cl;
    const float dcl_dc6 = on ? aj / ai : 0.0f;
    const float dcl_da = on ? -c6i * aj / (ai * ai) + c6j / aj : 0.0f;
    gsi[0] = -damp * (2.0f * c6j / cl - kk * dcl_dc6);
    gsi[1] = damp * kk * dcl_da;
    gsi[2] = -c6ij * ddrr * 3.0f * sj[2];
  }
};

// ---------------------------------------------------------------------------
// Member forms: one output per ensemble member of a fused ensemble.  Every
// atom carries kShared scalars common to the members and kPer scalars of
// each member, packed [shared (kShared), member 0 (kPer), member 1, ...];
// a pair's output for member m is e_ij,m = val(geo(d, sh_i, sh_j), m_i,m,
// m_j,m): geo() is what the members share (the geometry's kernel, the
// damping), computed once a pair, and val() and grad() one member's value
// and derivatives from it, the same float operations as the single-model
// term on that member's scalars.  grad() gives g, dg/dd, dg/dm_i (kPer) and
// dg/dsh_i (kShared).  One build holds kMaxMembers accumulators a lane;
// E <= kMaxMembers members run on it (kernels/pair_sweep.py::MAX_MEMBERS).
constexpr int kMaxMembers = 8;

// The Coulomb-type terms, q_i,m q_j,m h(d): DSF, simple, SR (in Real =
// double, as CoulombSRTerm) and the real-space Ewald sum.
template <class Base, class Real>
struct ChargeMembers {
  static constexpr bool kBilinear = false;
  static constexpr int kShared = 0;
  static constexpr int kPer = 1;
  static constexpr int kMaxMembers = pair_terms::kMaxMembers;
  static constexpr int kScalars = kShared + kMaxMembers * kPer;
  struct Geo {
    Real h, dh;
  };

  __device__ static Geo geo(const TermConsts& k, float d, const float*, const float*) {
    Geo r;
    Base::h(k, d, r.h, r.dh);
    return r;
  }

  __device__ static float val(const Geo& r, const float* mi, const float* mj) {
    return float(Real(mi[0]) * Real(mj[0]) * r.h);
  }

  __device__ static void grad(const Geo& r, const float*, const float* mi, const float* mj,
                              float& g, float& gd, float* gmi, float*) {
    g = float(Real(mi[0]) * Real(mj[0]) * r.h);
    gd = float(Real(mi[0]) * Real(mj[0]) * r.dh);
    gmi[0] = float(Real(mj[0]) * r.h);
  }
};

using DsfMembers = ChargeMembers<DsfTerm, float>;
using CoulombSimpleMembers = ChargeMembers<CoulombSimpleTerm, float>;
using CoulombSRMembers = ChargeMembers<CoulombSRTerm, double>;
using EwaldRealMembers = ChargeMembers<EwaldRealTerm, float>;

// D3 with the TS combination rule: the shared scalar is r4r2 (rr, r0 and
// the Becke-Johnson damping are computed once a pair), each member's are
// its C6 and alpha.  c = [cutoff, a1, a2, s8, s6, 1/Bohr], as D3TSTerm.
struct D3TSMembers {
  static constexpr bool kBilinear = false;
  static constexpr int kShared = 1;
  static constexpr int kPer = 2;
  static constexpr int kMaxMembers = pair_terms::kMaxMembers;
  static constexpr int kScalars = kShared + kMaxMembers * kPer;
  struct Geo {
    float damp, ddb, ddrr, bohr, rrj;
  };

  __device__ static Geo geo(const TermConsts& k, float d, const float* shi, const float* shj) {
    Geo r;
    bj_damping(d * k.c[5], 3.0f * shi[0] * shj[0], k.c[1], k.c[2], k.c[4], k.c[3], r.damp, r.ddb,
               r.ddrr);
    r.bohr = k.c[5];
    r.rrj = shj[0];
    return r;
  }

  __device__ static float val(const Geo& r, const float* mi, const float* mj) {
    const float den = mi[0] * mj[1] / mi[1] + mj[0] * mi[1] / mj[1];
    const float c6ij = 2.0f * mi[0] * mj[0] / fmaxf(den, 1e-4f);
    return -c6ij * r.damp;
  }

  __device__ static void grad(const Geo& r, const float*, const float* mi, const float* mj,
                              float& g, float& gd, float* gmi, float* gshi) {
    const float c6i = mi[0], ai = mi[1], c6j = mj[0], aj = mj[1];
    const float den = c6i * aj / ai + c6j * ai / aj;
    const bool on = den >= 1e-4f;  // where the clamp passes the gradient
    const float cl = fmaxf(den, 1e-4f);
    const float c6ij = 2.0f * c6i * c6j / cl;
    g = -c6ij * r.damp;
    gd = -c6ij * r.ddb * r.bohr;
    const float kk = c6ij / cl;
    const float dcl_dc6 = on ? aj / ai : 0.0f;
    const float dcl_da = on ? -c6i * aj / (ai * ai) + c6j / aj : 0.0f;
    gmi[0] = -r.damp * (2.0f * c6j / cl - kk * dcl_dc6);
    gmi[1] = r.damp * kk * dcl_da;
    gshi[0] = -c6ij * r.ddrr * 3.0f * r.rrj;
  }
};

}  // namespace pair_terms
