"""Driver smoke tests (C12-C18 of SURVEY.md section 2).

End-to-end CLI runs on a tiny problem (L=3, d=2, T=0.1 -> 11 steps):
optimize_ramp in both engine modes (fixed-N sector GEMM and MPS TEBD)
plus the ramp-consuming analysis drivers chained off its output files —
the reference's text-file dataflow (BHrampInitialFinal.txt is written by
optimizers and re-read by AnalyzeBondDim/CalculateDefects/
ExtendTimeEvolution, SURVEY.md section 5 'checkpoint/resume').
"""

import os

import numpy as np
import pytest

from optimalcontrolmps.drivers import (calculate_defects,
                                       extend_time_evolution,
                                       optimize_ramp)

TINY = """input
{{
tstep = 0.01
T = 0.1
N = 3
Npart = 3
d = 2
M = 4
gamma = 1e-6
maxBondDim = 10
optTol = 1e-6
useBFGS = yes
maxIter = 10
cacheProgress = yes
engine = {engine}
}}
"""


def _write_cfg(tmp_path, engine):
    cfg = tmp_path / f"InputFile_{engine}"
    cfg.write_text(TINY.format(engine=engine))
    return str(cfg)


@pytest.mark.parametrize("engine", ["sector", "mps", "vidal"])
def test_optimize_ramp_smoke(tmp_path, engine):
    cfg = _write_cfg(tmp_path, engine)
    prefix = str(tmp_path) + os.sep
    out = optimize_ramp.run(cfg, seed=1, out_prefix=prefix)
    assert 0.0 <= out["infidelity"] <= 1.0
    assert out["u_final"].shape == (11,)
    for f in ["BHrampInitialFinal.txt", "GROUPHessian.txt",
              "GRAPEHessian.txt", "ExpectationN.txt", "ProgressCache.txt",
              "checkpoint.json"]:
        assert (tmp_path / f).exists(), f
    # ExpectationN: particle number is conserved at every time
    expn = np.loadtxt(tmp_path / "ExpectationN.txt")
    np.testing.assert_allclose(expn[:, 1:].sum(axis=1), 3.0, atol=1e-5)


def test_engines_agree(tmp_path):
    """sector and mps drivers land on the same optimum (same channel)."""
    out_s = optimize_ramp.run(_write_cfg(tmp_path, "sector"), seed=1,
                              out_prefix=str(tmp_path / "s_"))
    out_m = optimize_ramp.run(_write_cfg(tmp_path, "mps"), seed=1,
                              out_prefix=str(tmp_path / "m_"))
    assert abs(out_s["infidelity"] - out_m["infidelity"]) < 1e-5
    np.testing.assert_allclose(out_s["u_final"], out_m["u_final"],
                               atol=1e-3)


def test_ramp_file_dataflow(tmp_path):
    """The ramp file written by the optimizer round-trips into the
    analysis drivers (the reference's checkpoint format)."""
    cfg = _write_cfg(tmp_path, "mps")
    prefix = str(tmp_path) + os.sep
    optimize_ramp.run(cfg, seed=1, out_prefix=prefix)
    ramp = str(tmp_path / "BHrampInitialFinal.txt")

    res = calculate_defects.run(cfg, ramp_path=ramp)
    assert np.all(np.asarray(res["fids"]) <= 1.0 + 1e-9)

    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        ext = extend_time_evolution.run(cfg, ramp, out_prefix=prefix)
    finally:
        os.chdir(old)
    # 100 extra constant-control steps appended (ExtendTimeEvolution.cpp:64-68)
    assert len(ext["times"]) == 11 + 100
    assert len(ext["fid_final"]) == 11 + 100


def test_auto_engine_honors_truncation(tmp_path):
    """engine=auto must pick the MPS path whenever maxBondDim actually
    truncates (chi < exact rank bound) so truncation-study configs keep
    the reference's truncated-MPS channel (ADVICE.md round 1), and the
    exact sector engine only when the MPS path would be truncation-free."""
    from optimalcontrolmps.config import parse_input_file
    from optimalcontrolmps.drivers.common import build_problem
    from optimalcontrolmps.tebd import exact_rank_bound

    # L=3, d=2 -> p=3, exact rank bound = 3; maxBondDim=10 -> chi=3 (capped)
    # >= bound -> truncation-free -> sector
    cfg = tmp_path / "cfg_free"
    cfg.write_text(TINY.format(engine="auto"))
    p = build_problem(parse_input_file(str(cfg)), seed=1, engine="auto")
    assert p.chi >= exact_rank_bound(p.L, p.d + 1)
    assert p.kind == "sector"

    # maxBondDim=2 < bound 3 -> real truncation -> must stay on MPS
    cfg2 = tmp_path / "cfg_trunc"
    cfg2.write_text(TINY.format(engine="auto").replace(
        "maxBondDim = 10", "maxBondDim = 2"))
    p2 = build_problem(parse_input_file(str(cfg2)), seed=1, engine="auto")
    assert p2.chi == 2 < exact_rank_bound(p2.L, p2.d + 1)
    assert p2.kind == "mps"


def test_amoeba_opt_smoke(tmp_path):
    """AmoebaOpt driver (C13): derivative-free NM run + output files."""
    from optimalcontrolmps.drivers import amoeba_opt

    cfg = tmp_path / "InputAmoeba"
    cfg.write_text(TINY.format(engine="mps").replace(
        "maxIter = 10", "maxIter = 40"))
    prefix = str(tmp_path) + os.sep
    out = amoeba_opt.run(str(cfg), seed=1, out_prefix=prefix)
    assert np.isfinite(out["f"]) and out["n_evals"] > 0
    assert (tmp_path / "BHrampInitialFinal.txt").exists()
    assert (tmp_path / "ProgressCache.txt").exists()


def test_analyze_bond_dim_smoke(tmp_path):
    """AnalyzeBondDim driver (C15): chi convergence study on a tiny chain.
    Fidelities must be monotonically non-degrading with chi at the end."""
    from optimalcontrolmps.drivers import analyze_bond_dim

    cfg = tmp_path / "InputABD"
    cfg.write_text(TINY.format(engine="mps"))
    res = analyze_bond_dim.run(str(cfg), bond_dims=(2, 3),
                               out_prefix=str(tmp_path) + os.sep)
    assert set(res) == {2, 3}
    for m in (2, 3):
        assert np.isfinite(res[m]["fids"]).all()
        assert res[m]["fids"].shape == (11,)
        assert np.isfinite(res[m]["grad"]).all()


def test_analyze_quench_smoke(tmp_path):
    """AnalyzeQuench driver (C16): entropies + correlation files."""
    from optimalcontrolmps.drivers import analyze_quench

    cfg = tmp_path / "InputAQ"
    cfg.write_text(TINY.format(engine="mps").replace("N = 3", "N = 4")
                   .replace("Npart = 3", "Npart = 4"))
    prefix = str(tmp_path) + os.sep
    res = analyze_quench.run(str(cfg), ramp="quench", out_prefix=prefix,
                             startpoint=0, endpoint=2)
    assert res["entropies"].shape == (11, 3)  # N_t x (L-1) bonds
    assert res["sp"].shape == (11, 2)
    for f in ["EntanglementEntropies_Quench.txt",
              "SingleParticleCorr_Quench.txt",
              "DensityDensityCorr_Quench.txt",
              "RescaledDensityDensityCorr_Quench.txt"]:
        assert (tmp_path / f).exists(), f
    # quench from the U=2.5 ground state: entropy grows from ~product state
    assert np.all(res["entropies"] >= -1e-9)


def test_test_runtimes_smoke():
    """TestRuntimes driver (C14): tables + cost consistency."""
    from optimalcontrolmps.drivers import test_runtimes

    res = test_runtimes.run(horizons=(0.1,), batches=(1, 2),
                            with_hessian=False)
    assert 0.1 in res["costs"]
    assert np.isfinite(res["costs"][0.1])


def test_optimize_ramp_host_ip_mode(tmp_path):
    """Reference-scale IP pathway at toy size: ipMode=host forces the
    streaming exact Hessian (BlockHessian) + host-loop interior point +
    dual-preserving checkpoints + streaming finalize — the exact code
    path of the BASELINE scaled-lattice solve (artifacts/baseline3),
    exercised end-to-end on the vidal engine so its finalize (streaming
    fidelities + streaming ExpectationN rollout) can never regress."""
    import json

    cfg = tmp_path / "InputFile_hostip"
    cfg.write_text("""input
{
tstep = 0.01
T = 0.1
N = 4
Npart = 4
d = 2
M = 5
gamma = 1e-6
maxBondDim = 16
optTol = 1e-6
useBFGS = no
maxIter = 3
cacheProgress = yes
engine = vidal
ipMode = host
hessianRowBlock = 5
hessianProgress = no
muStrategy = adaptive
}
""")
    prefix = str(tmp_path) + os.sep
    out = optimize_ramp.run(str(cfg), seed=1, out_prefix=prefix)
    assert 0.0 <= out["infidelity"] <= 1.0
    assert out["status"]["iterations"] >= 1
    # per-iteration ProgressCache lines with exact-Hessian Nprop
    lines = (tmp_path / "ProgressCache.txt").read_text().strip().splitlines()
    assert len(lines) == out["status"]["iterations"]
    # durable checkpoint carries the full primal-dual state
    ck = json.loads((tmp_path / "checkpoint.json").read_text())
    assert "duals" in ck["extra"] and len(ck["extra"]["duals"]) == 4
    # streaming finalize wrote the reference-format outputs
    for f in ["BHrampInitialFinal.txt", "ExpectationN.txt"]:
        assert (tmp_path / f).exists(), f
    expn = np.loadtxt(tmp_path / "ExpectationN.txt")
    np.testing.assert_allclose(expn[:, 1:].sum(axis=1), 4.0, atol=1e-5)
