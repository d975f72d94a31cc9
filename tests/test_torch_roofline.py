"""The port's roofline slice (repro_torch/roofline/*, launch/oracle.py's
RooflineOracle, launch/autotune.py) held against the JAX package's on
the CPU.

Pure arithmetic is held exactly (``==``): at the reference's TPU v5e
record every count, term, oracle price, hill-climb row, report row and
rendered table row equals the reference's on the same inputs, since both
run the same Python arithmetic on the same integers. The hypotheses'
prose is the port's own (it states no TPU time or rate), so the climbs'
logs are compared without it. On the H100 record (the default) each
term is its count over that record's rate. The tuner's replay uses the
port's toy classifier with the reference's head; its verdict equals the
reference's, and does not depend on the head. The reference's results
are computed once per module."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from port_isolation import port_module_isolation  # noqa: F401
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get as jax_get
from repro.launch import autotune as jat
from repro.launch import oracle as jor
from repro.roofline import costmodel as jcm
from repro.roofline import experiments_md as jmd
from repro.roofline import hillclimb as jhc
from repro.roofline import params as jpa
from repro.roofline import report as jrp
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get
from repro_torch.launch import autotune as tat
from repro_torch.launch import oracle as tor
from repro_torch.models.encdec import init_encdec
from repro_torch.models.lm import count_params, init_lm
from repro_torch.roofline import costmodel as tcm
from repro_torch.roofline import experiments_md as tmd
from repro_torch.roofline import hillclimb as thc
from repro_torch.roofline import params as tpa
from repro_torch.roofline import report as trp
from repro_torch.roofline.costmodel import H100, TPU_V5E

V5E = TPU_V5E
MESHES = {"single_pod": (1, 16, 16), "multi_pod": (2, 16, 16),
          "one_card": (1, 1, 1)}
# a small grid of the cost model's knobs (each dict one cell_cost call)
KNOBS = [
    {},
    dict(remat="none", microbatches=1),
    dict(remat="dots", microbatches=2, seq_shard=True, fsdp=True,
         moment_bytes=2),
    dict(int8_dispatch=True, ep_over_data=True, microbatches=8),
    dict(kv_int8=True, weights_int8=True, depth_fraction=0.5),
    dict(kv_int8=True, depth_fraction=1 / 36),
]
SERVED = ("qwen3_4b", "recurrentgemma_2b", "rwkv6_1p6b", "olmoe_1b_7b",
          "paligemma_3b", "whisper_base")
TINY_SPEC = {"cell": "t4k", "arch": "qwen3_8b", "ctx": 4096}
TINY_STEPS = [("slots 8->16", "wider pool under load", {"slots": 16})]
# the reference's toy head (repro/launch/workload.py::toy_classifier)
W_REF = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (32, 10))
                   / np.sqrt(32))


def _strip(log, key="hypothesis"):
    return [{k: v for k, v in r.items() if k != key} for r in log]


def _table_rows(md, drop_last=False):
    """The markdown table rows of a rendered section, split into cells;
    ``drop_last`` drops each row's last column (its prose)."""
    rows = [l.split(" | ") for l in md.splitlines() if l.startswith("| ")
            and not l.startswith("| arch |") and not l.startswith("| # |")]
    return [r[:-1] if drop_last else r for r in rows]


@pytest.fixture(scope="module")
def ref():
    """The reference's results, once per module."""
    return {
        "climbs": {n: getattr(jhc, n)() for n in (
            "hillclimb_olmoe", "hillclimb_llama4", "hillclimb_qwen_decode")},
        "tables": {mp: jrp.full_table(mp) for mp in (False, True)},
        "tiny": jat.autotune_cell(TINY_SPEC, budget="tiny",
                                  steps=TINY_STEPS),
    }


# ------------------------------------------------------------- params ----

def test_configs_are_the_references():
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)
    assert list(SHAPES) == list(JAX_SHAPES)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_reference(arch):
    cfg, jcfg = get(arch), jax_get(arch)
    for stub in (False, True):
        assert tpa.analytic_param_count(cfg, include_stub_pos=stub) == \
            jpa.analytic_param_count(jcfg, include_stub_pos=stub)
    assert tpa.analytic_active_param_count(cfg) == \
        jpa.analytic_active_param_count(jcfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_is_the_port_trees_and_decode_bytes_cover_it(arch):
    """The analytic count is the port's own param tree's (reduced, with
    the encoder-decoder's full position tables), and a decode cell's HBM
    bytes cover every bf16 weight a step reads (a position table: one
    row)."""
    cfg = get(arch).reduced()
    init = init_encdec if cfg.is_encdec else init_lm
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert tpa.analytic_param_count(cfg, include_stub_pos=True) == \
        count_params(params)
    read = sum(l.numel() if not pytree.keystr(p).endswith("pos']")
               else l.shape[-1]
               for p, l in pytree.tree_flatten_with_path(params)[0])
    one = tcm.Mesh2D(1, 1, 1)
    assert tcm.decode_hbm_bytes(cfg, 8, 160, one) >= tcm.BF16 * read


def test_moe_decode_bytes_count_active_experts_only():
    """The reference's decode bytes count the ACTIVE parameters: at full
    width OLMoE's decode cell reads about a fifth of its weights, below
    the every-expert weight bytes a batch-8 top-8 step really reads."""
    cfg = get("olmoe_1b_7b")
    one = tcm.Mesh2D(1, 1, 1)
    every = tcm.BF16 * tpa.analytic_param_count(cfg)
    got = tcm.decode_hbm_bytes(cfg, 8, 160, one)
    assert 0.15 * every < got < 0.3 * every


# ---------------------------------------------------------- cost model ----

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_cost_equals_reference_on_the_v5e_record(arch):
    cfg, jcfg = get(arch), jax_get(arch)
    for shape in SHAPES:
        for pdm in MESHES.values():
            for kw in KNOBS:
                port = tcm.cell_cost(cfg, SHAPES[shape], tcm.Mesh2D(*pdm),
                                     chip=V5E, **kw)
                want = jcm.cell_cost(jcfg, JAX_SHAPES[shape],
                                     jcm.Mesh2D(*pdm), **kw)
                assert dataclasses.asdict(port) == \
                    dataclasses.asdict(want), (shape, pdm, kw)


def test_v5e_record_is_the_references_constants():
    assert (V5E.peak_flops, V5E.hbm_bw, V5E.link_bw) == \
        (jcm.PEAK_FLOPS, jcm.HBM_BW, jcm.LINK_BW)
    assert (H100.name, H100.peak_flops, H100.hbm_bw, H100.link_bw) == \
        ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_h100_terms_are_counts_over_its_rates(shape):
    """The default record is the H100, and each term is its count over
    that record's rate; the counts do not depend on the chip."""
    cfg = get("qwen3_4b")
    mesh = tcm.Mesh2D(1, 2, 4)
    t = tcm.cell_cost(cfg, SHAPES[shape], mesh)
    v = tcm.cell_cost(cfg, SHAPES[shape], mesh, chip=V5E)
    assert (t.flops_total, t.hbm_bytes_dev, t.coll_bytes_dev) == \
        (v.flops_total, v.hbm_bytes_dev, v.coll_bytes_dev)
    assert t.t_compute == t.flops_total / (8 * 989e12)
    assert t.t_memory == t.hbm_bytes_dev / 3.35e12
    assert t.t_collective == t.coll_bytes_dev / 450e9


# -------------------------------------------------------------- oracle ----

@pytest.mark.parametrize("arch", ("qwen3_8b",) + SERVED)
def test_roofline_oracle_costs_equal_reference(arch):
    port = tor.RooflineOracle(get(arch), ctx=4096, chip=V5E)
    want = jor.RooflineOracle(jax_get(arch), ctx=4096)
    assert port.unit == want.unit == "device_us"
    assert port.n_groups == want.n_groups
    shape = (32,)
    for w in range(1, 33):
        assert port.step_time(w) == want.step_time(w)
        assert port.probe_cost(shape, w, 2) == want.probe_cost(shape, w, 2)
        assert port.segment_cost(shape, 2, w, 1) == \
            want.segment_cost(shape, 2, w, 1)
        assert port.solve_cost(shape, 4, w, 2) == \
            want.solve_cost(shape, 4, w, 2)
        assert port.flow_cost(shape, w) == want.flow_cost(shape, w)


@pytest.mark.parametrize("arch", ("qwen3_8b",) + SERVED)
def test_one_card_oracle_prices_what_the_reference_prices(arch):
    """On one device the oracle leaves the collective term out; at every
    width and context the parity tests price (and the tuned cells' 32k
    context), that term stays below compute or memory, so each step time
    is still the reference's max of the three terms."""
    one = tcm.Mesh2D(1, 1, 1)
    for chip in (V5E, H100):
        o = tor.RooflineOracle(get(arch), ctx=4096, chip=chip)
        for ctx in (4096, 32768):
            for w in range(1, 33):
                t = tcm.cell_cost(
                    get(arch), ShapeSpec(f"oracle_decode{ctx}_b{w}",
                                         "decode", ctx, w), one,
                    depth_fraction=1.0 / o.n_groups, chip=chip)
                assert t.t_collective < max(t.t_compute, t.t_memory), \
                    (chip.name, ctx, w)
                if ctx == 4096:
                    assert o.step_time(w) == 1e6 * max(
                        t.t_compute, t.t_memory, t.t_collective)


def test_one_card_train_row_is_memory_bound():
    """OLMoE-1B-7B's 8-bit train step (8 x 128, one microbatch, one-byte
    moments) on one card: ``cell_cost`` still prices the interconnect
    (its collective term is the largest, as the reference's), but one
    card sends none, so ``predicted`` names memory and reports the
    collective term beside it. On a mesh of several devices the
    prediction stays the max of the three terms."""
    cfg = get("olmoe_1b_7b")
    spec = ShapeSpec("train_8x128", "train", 128, 8)
    kw = dict(remat="none", microbatches=1, moment_bytes=1)
    t = tcm.cell_cost(cfg, spec, tcm.Mesh2D(1, 1, 1), **kw)
    assert t.dominant == "collective" and t.t_collective > t.t_memory
    assert tcm.predicted(t, tcm.Mesh2D(1, 1, 1)) == (t.t_memory, "memory")
    wide = tcm.Mesh2D(1, 2, 1)
    tw = tcm.cell_cost(cfg, spec, wide, **kw)
    assert tcm.predicted(tw, wide) == (
        max(tw.t_compute, tw.t_memory, tw.t_collective), tw.dominant)


def test_make_oracle_and_unit_tags_match_reference():
    o = tor.make_oracle("roofline", get("qwen3_4b"), ctx=128)
    assert isinstance(o, tor.RooflineOracle) and o.chip == H100
    assert o.ctx == 128 and isinstance(o, tor.CostOracle)
    assert isinstance(tor.make_oracle("sequential"),
                      tor.SequentialEvalOracle)
    assert tor.WALLCLOCK_UNIT == jor.WALLCLOCK_UNIT
    for bad in (lambda: tor.make_oracle("roofline"),
                lambda: tor.make_oracle("wall")):
        with pytest.raises(ValueError):
            bad()


# ----------------------------------------------------------- hillclimb ----

@pytest.mark.parametrize("name", ["hillclimb_olmoe", "hillclimb_llama4",
                                  "hillclimb_qwen_decode"])
def test_hillclimbs_equal_reference(ref, name):
    port = getattr(thc, name)(V5E)
    assert _strip(port) == _strip(ref["climbs"][name])
    assert all(r["hypothesis"] for r in port[1:])
    h100 = getattr(thc, name)()
    assert [r["change"] for r in h100] == [r["change"] for r in port]


def _terms(c, m, l):
    return tcm.RooflineTerms(flops_total=1.0, hbm_bytes_dev=1.0,
                             coll_bytes_dev=1.0, model_flops=1.0,
                             t_compute=c, t_memory=m, t_collective=l)


def _table_cost(table):
    def fn(cfg, shape, mesh, **kw):
        return _terms(*table[frozenset(kw.items())])
    return fn


def test_hillclimb_scores_the_new_bottleneck_after_a_flip():
    """The reference's pins on ``_iterate``: a flip is scored on the new
    dominant term (1 % here: refuted), a real gain on it confirms and
    carries forward."""
    cost = _table_cost({
        frozenset(): (1.0, 9.9, 10.0),
        frozenset({("int8_a2a", True)}): (1.0, 9.9, 1.0),
    })
    row = thc._iterate("synthetic", None, None, {},
                       [("int8_a2a", "", {"int8_a2a": True}, None)],
                       cost_fn=cost)[1]
    assert (row["dominant_before"], row["dominant_after"]) == \
        ("collective", "memory")
    assert row["prev_dominant_term_after_s"] == 1.0
    assert row["verdict"].startswith("REFUTED")
    assert row["gain_on_dominant"] == "1.0%"
    cost = _table_cost({
        frozenset(): (1.0, 4.0, 10.0),
        frozenset({("a", True)}): (1.0, 4.0, 2.0),
        frozenset({("a", True), ("b", True)}): (1.0, 3.0, 2.0),
    })
    log = thc._iterate("synthetic", None, None, {},
                       [("a", "", {"a": True}, None),
                        ("b", "", {"b": True}, None)], cost_fn=cost)
    assert log[1]["verdict"] == log[2]["verdict"] == "CONFIRMED"
    assert log[2]["dominant_term_before_s"] == 4.0


def test_hypothesis_loop_equals_reference():
    scores = {frozenset(): 100.0, frozenset({("x", 2)}): 50.0,
              frozenset({("x", 2), ("y", 1)}): 49.5,
              frozenset({("x", 2), ("z", 0)}): 25.0}
    evaluate = lambda kw: (scores[frozenset(kw.items())], {"n": len(kw)})
    steps = [("x", "h", {"x": 2}), ("y", "h", {"y": 1}),
             ("z", "h", {"z": 0})]
    assert thc.hypothesis_loop(evaluate, steps, {}) == \
        jhc.hypothesis_loop(evaluate, steps, {})


# -------------------------------------------------------------- report ----

@pytest.mark.parametrize("multi_pod", [False, True], ids=["sp", "mp"])
def test_full_table_equals_reference(ref, multi_pod, tmp_path, monkeypatch):
    # the cost model's rows alone: the port's committed dry-run artifacts
    # add memory columns (test_rows_gain_the_dry_runs_memory), and the
    # reference has no artifacts here to add its own
    monkeypatch.setattr(trp, "ART", str(tmp_path))
    assert trp.full_table(multi_pod, chip=V5E) == ref["tables"][multi_pod]
    assert trp.settings_for("whisper_base") == \
        jrp.settings_for("whisper_base")
    assert trp.markdown_table(ref["tables"][multi_pod]) == \
        jrp.markdown_table(ref["tables"][multi_pod])


def test_rows_gain_the_dry_runs_memory(tmp_path, monkeypatch):
    """A row on a large mesh carries the per-device memory, collective
    ops and trace seconds of the dry-run artifact of its cell."""
    art = {"status": "OK", "trace_s": 1.5,
           "memory": {"temp_bytes": 3 * 2 ** 30, "argument_bytes": 2 ** 30},
           "collective_counts": {"all-gather": 0, "all-reduce": 7}}
    os.makedirs(tmp_path / "dryrun")
    with open(tmp_path / "dryrun" / "qwen3_8b__train_4k__sp.json", "w") as f:
        json.dump(art, f)
    monkeypatch.setattr(trp, "ART", str(tmp_path))
    row = trp.cell_row("qwen3_8b", "train_4k")
    assert (row["dev_temp_gib"], row["dev_args_gib"], row["trace_s"]) == \
        (3.0, 1.0, 1.5) and row["traced_coll_ops"] == {"all-reduce": 7}
    assert "dev_temp_gib" not in trp.cell_row("qwen3_8b", "train_4k",
                                              multi_pod=True)


def test_rendered_rows_equal_reference(ref):
    """The port's §Roofline and §Perf sections render the reference's
    rows cell for cell (the prose column aside: it is the port's)."""
    rows = ref["tables"][False]
    assert _table_rows(tmd.roofline_section(rows, V5E), drop_last=True) \
        == _table_rows(jmd.roofline_section(rows), drop_last=True)
    log = [r for n in ("hillclimb_olmoe", "hillclimb_llama4",
                       "hillclimb_qwen_decode") for r in ref["climbs"][n]]
    drop_hyp = lambda rows: [r[:2] + r[3:] for r in rows]
    port_md, ref_md = tmd.perf_section(log), jmd.perf_section(log)
    assert drop_hyp(_table_rows(port_md)) == drop_hyp(_table_rows(ref_md))
    base = lambda md: [l for l in md.splitlines()
                       if l.startswith("Baseline:")]
    assert base(port_md) == base(ref_md) and len(base(port_md)) == 3


def test_clis_write_the_ports_artifacts(tmp_path, monkeypatch, capsys):
    """report, hillclimb and experiments_md write under the port's
    artifact folder, print the H100 record and the what-if meshes, and
    EXPERIMENTS.md names torch and the card's record, not JAX or a TPU
    constant."""
    for mod in (trp, thc, tmd):
        monkeypatch.setattr(mod, "ART", str(tmp_path))
    trp.main([])
    thc.main()
    out = capsys.readouterr().out
    assert "NVIDIA H100 80GB HBM3" in out and "what-if" in out
    rows = json.load(open(tmp_path / "roofline_baseline.json"))
    assert {r["mesh"] for r in rows if r["status"] == "OK"} == \
        {"16x16", "2x16x16", "1x1x1"}
    assert len(json.load(open(tmp_path / "hillclimb_log.json"))) == 15
    tmd.main()
    md = open(tmp_path / "EXPERIMENTS.md").read()
    assert f"PyTorch {torch.__version__}" in md and H100.name in md
    assert "## §Dry-run" in md and "repro_torch.launch.dryrun" in md \
        and "ROADMAP item 13" in md
    for tpu in ("JAX", "197 TFLOP", "819 GB", "v5e", "ICI"):
        assert tpu not in md, tpu
    assert len(_table_rows(md)) >= len(rows)


# --------------------------------------------------------------- tuner ----

def test_autotune_tiny_equals_reference_and_needs_no_head(ref):
    """The reference's single-step ``tiny`` call: the port's verdict on
    the v5e record with the reference's head equals the reference's
    dict; with the CLI's numpy head every score is the same (K comes
    from the probe of the field, not from the head)."""
    port = tat.autotune_cell(TINY_SPEC, budget="tiny", steps=TINY_STEPS,
                             W=W_REF, chip=V5E)
    assert {k: port[k] for k in ref["tiny"]} == ref["tiny"]
    assert port["head"] == "caller" and port["chip"] == "TPU v5e"
    own = tat.autotune_cell(TINY_SPEC, budget="tiny", steps=TINY_STEPS,
                            chip=V5E)
    assert own["log"] == port["log"] and own["head"] == tat.HEAD_SOURCE
    assert (tat.DEFAULT_BASE, tat.DEFAULT_STEPS, tat._BUDGET_N,
            tat.TUNE_CELLS) == (jat.DEFAULT_BASE, jat.DEFAULT_STEPS,
                                jat._BUDGET_N, jat.TUNE_CELLS)


@pytest.mark.parametrize("cell", [c["cell"] for c in tat.TUNE_CELLS])
def test_committed_verdicts_are_the_clis_on_h100_terms(cell):
    """Each committed verdict was tuned on the H100 record at the small
    budget with the numpy head, and its chosen knobs replay to its tuned
    p99 (one replay, not a rerun of the tuner)."""
    res = tat.load_tuned(cell)
    spec = next(c for c in tat.TUNE_CELLS if c["cell"] == cell)
    assert res["chip"] == H100.name and res["cost_unit"] == "device_us"
    assert res["head"] == tat.HEAD_SOURCE and res["requests"] == 48
    assert tat.tuned_path(cell).endswith(
        os.path.join("artifacts", "torch", "tuned", f"{cell}.json"))
    oracle = tor.RooflineOracle(get(spec["arch"]), ctx=spec["ctx"])
    xs = tat.heterogeneous_requests(48, 32, seed=3)
    trace = tat.poisson_trace(
        xs, rate=1.0 / oracle.step_time(res["base"]["slots"]), seed=103)
    evaluate = tat.make_objective(oracle, trace, tat.toy_head())
    assert evaluate(res["chosen"])[0] == res["p99_tuned"]
