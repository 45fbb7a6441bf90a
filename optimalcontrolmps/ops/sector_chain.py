"""Batched sector-engine Trotter chain with a reversible custom VJP.

The multistart solve's hot loop is the merged-phase GEMM chain
(sector.py rollout_final: h <- phase(u_i)^2 . (WJ h) per step, one
(ns_p, ns_p) complex GEMM + one elementwise phase pass), run for a whole
(B, N_t) batch of control trajectories at every L-BFGS evaluation:

* complex arithmetic is explicit real pairs: one chain step is four
  (B, 128) x (128, 128) f32 products plus a cos/sin phase rotation,
  compiled by XLA as a `lax.scan` (cuBLAS products on a GPU);
* every batch lane carries ITS OWN control trajectory (multistart), so
  the phase angle is the outer product u_i[b] x nn1;
* the backward pass stores no trajectory: the chain is unitary, so
  h_{i-1} = WJ^H (conj(p_i) . h_i) reconstructs states on the fly
  (reversible integration) while the cotangent propagates. Autodiff
  through the scan would keep all N_t (B, 128) states alive instead.

`chain_final(st, u_bt, psi0)` is the public entry: a custom-vjp function
returning the normalized final sector state psi_T for a (B, N_t) control
batch. A fused Triton kernel of the same algebra was measured 37x slower
than this scan on an H100 and removed (PERF.md, Bring-up findings).

Reference parity: the chain implements BH_tDMRG::step's split-step
Trotter product (reference src/BH_tDMRG.cpp:111-124) projected on the
fixed-N sector, exactly as sector.rollout_final does.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .precision import enforce_matmul_precision

__all__ = ["chain_final"]


def _chain_final_scan(dt, Wr, Wi, nn1, u_bt, h0r, h0i):
    """(B, N_t) controls -> (B, n) final half-phased state, real pairs.

    h_0 = D(u_0) psi_0 (quarter phase), then
    h_i = D(u_i)^2 (W h_{i-1}) (half phase) for i = 1..N_t-1 —
    exactly sector.rollout_final's merged-phase chain. Row-vector form:
    h_row <- h_row W^T."""
    ph0 = (-0.25 * dt) * jnp.outer(u_bt[:, 0], nn1)       # (B, n)
    c0, s0 = jnp.cos(ph0), jnp.sin(ph0)
    hr = c0 * h0r[None, :] - s0 * h0i[None, :]
    hi = c0 * h0i[None, :] + s0 * h0r[None, :]
    WrT, WiT = Wr.T, Wi.T

    def body(carry, u_i):
        hr, hi = carry
        ar = hr @ WrT - hi @ WiT                          # (B, n)
        ai = hr @ WiT + hi @ WrT
        ph = (-0.5 * dt) * jnp.outer(u_i, nn1)
        c, s = jnp.cos(ph), jnp.sin(ph)
        return (c * ar - s * ai, c * ai + s * ar), None

    (hr, hi), _ = jax.lax.scan(body, (hr, hi), u_bt[:, 1:].T)
    return hr, hi


def _scan_bwd(dt, Wr, Wi, nn1, u_bt, hTr, hTi, gTr, gTi):
    """Reversible backward: reconstruct h_{i-1} by inverse (unitary)
    propagation while the cotangent propagates through W^H.

    Cotangent convention: L real, g = (dL/d hr, dL/d hi) as a real pair.
    A phase rotation h = R(ph) a has vjp g_a = R(-ph) g_h and
    dL/dph = sum_n (g_hi h_r - g_hr h_i); the chain rule over the
    angle ph_i = coeff * u_i * nn1 gives du_i."""
    def body(carry, u_i):
        hr, hi, gr, gi = carry
        du_i = (-0.5 * dt) * jnp.sum(nn1[None, :] * (gi * hr - gr * hi),
                                     axis=1)
        ph = (-0.5 * dt) * jnp.outer(u_i, nn1)
        c, s = jnp.cos(ph), jnp.sin(ph)
        ar = c * hr + s * hi                              # R(-ph) h
        ai = c * hi - s * hr
        br = c * gr + s * gi                              # R(-ph) g
        bi = c * gi - s * gr
        # x_row W^H  (re = xr Wr + xi Wi, im = xi Wr - xr Wi)
        hr2 = ar @ Wr + ai @ Wi
        hi2 = ai @ Wr - ar @ Wi
        gr2 = br @ Wr + bi @ Wi
        gi2 = bi @ Wr - br @ Wi
        return (hr2, hi2, gr2, gi2), du_i

    (hr, hi, gr, gi), dus = jax.lax.scan(
        body, (hTr, hTi, gTr, gTi), u_bt[:, 1:].T[::-1])
    du0 = (-0.25 * dt) * jnp.sum(nn1[None, :] * (gi * hr - gr * hi), axis=1)
    return jnp.concatenate([du0[:, None], dus[::-1].T], axis=1)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _chain(dt, Wr, Wi, nn1, u_bt, h0r, h0i):
    return _chain_final_scan(dt, Wr, Wi, nn1, u_bt, h0r, h0i)


def _chain_fwd_rule(dt, Wr, Wi, nn1, u_bt, h0r, h0i):
    out = _chain_final_scan(dt, Wr, Wi, nn1, u_bt, h0r, h0i)
    return out, (Wr, Wi, nn1, u_bt, out[0], out[1])


def _chain_bwd_rule(dt, res, g):
    Wr, Wi, nn1, u_bt, hTr, hTi = res
    du = _scan_bwd(dt, Wr, Wi, nn1, u_bt, hTr, hTi, *g)
    # W/nn1/h0 are problem constants — zero cotangents keep the vjp total
    return (jnp.zeros_like(Wr), jnp.zeros_like(Wi), jnp.zeros_like(nn1),
            du, jnp.zeros_like(hTr[0]), jnp.zeros_like(hTi[0]))


_chain.defvjp(_chain_fwd_rule, _chain_bwd_rule)


def _operands(st, u_bt, psi0):
    """Real-pair f32 operands of the chain for a SectorStepper."""
    n = st.ns_p
    Wr = jnp.asarray(np.real(np.asarray(st.WJ_fwd_p)), jnp.float32)
    Wi = jnp.asarray(np.imag(np.asarray(st.WJ_fwd_p)), jnp.float32)
    nn1 = jnp.asarray(np.asarray(st.nn1_p), jnp.float32)
    p0 = np.zeros(n, np.complex64)
    p0[:st.ns] = np.asarray(psi0).astype(np.complex64)
    h0r = jnp.asarray(p0.real, jnp.float32)
    h0i = jnp.asarray(p0.imag, jnp.float32)
    return Wr, Wi, nn1, jnp.asarray(u_bt, jnp.float32), h0r, h0i


def _finish(st, u_bt, hTr, hTi):
    """Strip the doubled trailing phase (power -1) and renormalize once."""
    hT = jax.lax.complex(hTr, hTi)[:, :st.ns]
    ph = jnp.exp((0.25j * st.dt) * u_bt[:, -1:] * st.nn1[None, :]
                 ).astype(hT.dtype)
    psiT = hT * ph
    nrm = jnp.linalg.norm(psiT, axis=1, keepdims=True)
    return psiT / jnp.where(nrm > 1e-16, nrm, 1.0).astype(psiT.dtype)


@enforce_matmul_precision
def chain_final(st, u_bt, psi0):
    """Batched merged-phase chain: (B, N_t) controls -> (B, ns) final
    SECTOR state psi_T (normalized, trailing phase stripped), complex64.

    st: SectorStepper. psi0: (ns,) complex host vector. The chain runs in
    f32 real pairs; only the final fix-up is complex. Differentiable in
    u_bt (custom VJP, reversible backward)."""
    Wr, Wi, nn1, u_bt, h0r, h0i = _operands(st, u_bt, psi0)
    hTr, hTi = _chain(float(st.dt), Wr, Wi, nn1, u_bt, h0r, h0i)
    return _finish(st, u_bt, hTr, hTi)


@enforce_matmul_precision
def chain_final_autodiff(st, u_bt, psi0):
    """chain_final with no custom VJP: jax.grad differentiates through
    the scan (storing every step). The independent reference the
    reversible backward is checked against."""
    Wr, Wi, nn1, u_bt, h0r, h0i = _operands(st, u_bt, psi0)
    hTr, hTi = _chain_final_scan(float(st.dt), Wr, Wi, nn1, u_bt, h0r, h0i)
    return _finish(st, u_bt, hTr, hTi)
