"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.roofline``) against the JAX package's, on the CPU:

1. ``model_flops``, ``roofline_terms`` and the collectives' ring model
   equal JAX's exactly;
2. ``input_specs`` gives JAX's shapes and dtypes, caches included;
3. each kernel's operator gives, on meta tensors, the plain version's
   output shapes, dtypes and strides, and its flop formula counts the
   kernel's own work (``tests/test_torch_cuda.py`` opchecks the operators
   on the card); the counter counts a prefill by hand;
4. on a fake (2, 4) mesh one reduced arch per family runs train, prefill
   and decode to ``status: ok`` (as ``tests/test_dryrun_small.py`` lowers
   them in JAX), and a dense train cell's per-device matrix-product flops
   hold JAX's compiled program's to 1 %; at full size on the (16, 16)
   mesh, the dims that ``model`` does not divide stay whole on every rank,
   where JAX's compiled program shards them over gcd(dim, 16) ranks
   (ROADMAP queue 3, m).

JAX compiles only in a subprocess with 8 forced host devices, started by
the module's first test so that it runs beside the port's cells."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import roofline as jroofline
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro_torch import roofline
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import init_params, prefill
from repro_torch.sharding import ctx

ROOT = Path(__file__).resolve().parents[1]
KINDS = {"train": ShapeConfig("t", "train", 64, 8),
         "prefill": ShapeConfig("p", "prefill", 64, 8),
         "decode": ShapeConfig("d", "decode", 64, 8)}
FAMILIES = {}
for _name, _cfg in ARCHS.items():
    FAMILIES.setdefault(_cfg.family, _name)
# the dense cell whose flops are held to JAX's: phi3's MHA, reduced, with
# as many KV heads as query heads (4), so the (2, 4) mesh divides every
# dim; two microbatches of 4 x 64 tokens
FLOPS_ARCH, FLOPS_ACCUM = "phi3-mini-3.8b", 2
JAX_FLOPS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax
from repro.configs import get_arch
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import lower_cell
from repro.roofline import _dot_flops, _mult_map, analyze_hlo, parse_hlo
mesh = jax.make_mesh((2, 4), ("data", "model"))
cfg = dataclasses.replace(get_arch("%s").reduced(), n_kv_heads=4,
                          grad_accum=%d)
text = lower_cell(cfg, ShapeConfig("t", "train", 64, 8), mesh).compile(
    ).as_text()
comps = parse_hlo(text)
mult, _ = _mult_map(comps)
defs = {op.name: op.result_type for c in comps.values()
        for op in c.ops.values()}
dots = {"batched": 0.0, "plain": 0.0}
for name, comp in comps.items():
    if name == "__entry__" or name not in mult:
        continue
    for op in comp.ops.values():
        if op.opcode == "dot":
            key = "batched" if "lhs_batch_dims" in op.line else "plain"
            dots[key] += _dot_flops(op, defs) * mult[name]
print("FLOPS " + json.dumps({"total": analyze_hlo(text).flops, **dots}))
""" % (FLOPS_ARCH, FLOPS_ACCUM)


def _jax_dryrun():
    """``repro.launch.dryrun``, whose import would set XLA_FLAGS for 512
    host devices in this process if it had none: it gets an empty one."""
    had = "XLA_FLAGS" in os.environ
    os.environ.setdefault("XLA_FLAGS", "")
    try:
        import repro.launch.dryrun as jdryrun
    finally:
        if not had:
            del os.environ["XLA_FLAGS"]
    return jdryrun


@pytest.fixture(scope="module", autouse=True)
def jax_flops():
    """JAX's compile of the dense cell, in a subprocess that runs beside
    the module's tests. After them: the dry run sets the sharding context
    and a fake process group, and neither may leak into the tests that run
    after this file."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_FLOPS], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    import torch.distributed as dist
    ctx.clear()
    ctx.set_moe_groups(1)
    if dist.is_initialized():
        dist.destroy_process_group()
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


# ------------------------------------------------------------ 1: formulas
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_flops_equal_jax(arch, shape):
    jd = _jax_dryrun()
    assert dryrun.model_flops(ARCHS[arch], SHAPES[shape]) == \
        jd.model_flops(JAX_ARCHS[arch], JAX_SHAPES[shape])


@pytest.mark.parametrize("seed", range(3))
def test_roofline_terms_equal_jax(seed):
    """The same counts give JAX's terms, key for key; with each term made
    the largest in turn."""
    rng = np.random.default_rng(seed)
    vals = dict(zip(("flops", "hbm_bytes", "link_bytes",
                     "kernel_region_bytes"), rng.uniform(1e9, 1e15, 4)))
    vals[["flops", "hbm_bytes", "link_bytes"][seed]] *= 1e4
    rates = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9}
    mine = roofline.roofline_terms(roofline.RooflineCounts(**vals), **rates)
    theirs = jroofline.roofline_terms(jroofline.RooflineCounts(**vals),
                                      **rates)
    assert mine == theirs


def test_typed_terms_put_each_dtype_at_its_peak():
    """The dry run's rows and the card's check share one compute term:
    bf16 flops at the tensor-core peak, fp32 flops at the fp32 peak, a
    dtype without a peak at the fastest, and ``roofline_terms``' own
    terms kept as they were."""
    from repro_torch.launch.mesh import PEAK_FLOPS_BY_DTYPE
    counts = roofline.RooflineCounts(flops=3e12, hbm_bytes=3.35e12,
                                     link_bytes=0.0)
    terms = roofline.roofline_terms(counts, peak_flops=989e12,
                                    hbm_bw=3.35e12, ici_bw=450e9)
    typed = roofline.typed_terms(
        terms, {"bfloat16": 989e12, "float32": 67e12, "int64": 989e12},
        PEAK_FLOPS_BY_DTYPE)
    assert {k: typed[k] for k in terms} == terms
    assert typed["compute_typed_s"] == pytest.approx(3.0, rel=1e-12)
    assert typed["bound_typed_s"] == typed["compute_typed_s"]
    assert terms["bound_s"] == pytest.approx(1.0, rel=1e-12)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("group", [2, 16])
def test_collective_ring_model_equals_jax(kind, group):
    op = jroofline.Op("c", kind, "f32[1024,8]",
                      f"%c = f32[1024,8] {kind}(%x), "
                      f"replica_groups=[{512 // group},{group}]<=[512]")
    assert roofline.collective_link_bytes(kind, 1024 * 8 * 4, group) == \
        jroofline._collective_link_bytes(op, {})


# ---------------------------------------------------------- 2: input specs
def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.",
                                                                ""))}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_jax(arch):
    jd = _jax_dryrun()
    for name, shape in SHAPES.items():
        mine = dryrun.input_specs(ARCHS[arch], shape)
        theirs = jd.input_specs(JAX_ARCHS[arch], JAX_SHAPES[name])
        assert _flat(mine) == _flat(theirs), (arch, name)
        assert all(t.is_meta for t in roofline._tensors(mine))


# ------------------------------------------------ 3: the kernels' operators
def _rand(rng, shape, dtype=torch.float32, low=-1.0, high=1.0):
    return torch.from_numpy(rng.uniform(low, high, shape).astype(
        np.float32)).to(dtype)


def _cases(rng):
    """{op: (wrapper, plain version, CPU inputs)} at small shapes."""
    q = _rand(rng, (2, 40, 4, 32), torch.bfloat16)
    k = _rand(rng, (2, 40, 2, 32), torch.bfloat16)
    qd = _rand(rng, (2, 2, 2, 32), torch.bfloat16)
    kc = _rand(rng, (2, 48, 2, 32), torch.bfloat16)
    lens = torch.tensor([30, 48], dtype=torch.int32)
    r = _rand(rng, (2, 20, 3, 16))
    w = _rand(rng, (2, 20, 3, 16), low=0.9, high=0.999)
    u = _rand(rng, (3, 16))
    dt = _rand(rng, (2, 20, 16), torch.bfloat16)
    bc = _rand(rng, (2, 20, 16), torch.bfloat16)
    vec, a_log = _rand(rng, (16,)), _rand(rng, (16, 8), low=0.0, high=1.0)
    return {
        "flash_attention": (fa.flash_attention, fa.flash_attention_plain,
                            (q, k, k, 16)),
        "decode_attention": (da.decode_attention, da.decode_attention_plain,
                             (qd, kc, kc, lens)),
        "wkv6": (wk.wkv6, wk.wkv6_plain, (r, r, r, w, u)),
        "mamba_scan": (ms.mamba_scan, ms.mamba_scan_plain,
                       (dt, vec, bc[..., :8], bc[..., 8:], dt, dt, a_log,
                        vec)),
    }


def _meta(args):
    return tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "wkv6", "mamba_scan"])
def test_fake_impl_matches_the_plain_version(name):
    """On meta tensors the wrapper takes the operator's fake
    implementation: every output (y and the final state of a recurrence)
    has the plain version's shape, dtype and strides, and nothing
    launches."""
    wrapper, plain, args = _cases(np.random.default_rng(0))[name]
    want = plain(*args)
    got = wrapper(*_meta(args))
    want, got = (t if isinstance(t, tuple) else (t,) for t in (want, got))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_meta
        assert (g.shape, g.dtype, g.stride()) == (w.shape, w.dtype,
                                                  w.stride())
    assert wrapper.launches == 0


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "wkv6", "mamba_scan"])
def test_flop_formula_counts_the_kernels_work(name):
    """``FlopCounterMode`` counts each operator by its formula: the
    visible (query, key) pairs; every slot of the cache; 5 hd^2 a token
    and head; (7 n + 10) a token and channel."""
    from torch.utils.flop_counter import FlopCounterMode
    wrapper, _, args = _cases(np.random.default_rng(0))[name]
    with FlopCounterMode(display=False) as counter:
        wrapper(*_meta(args))
    want = {"flash_attention": 4 * 2 * 4 * 32 * (16 * 17 // 2 + 24 * 16),
            "decode_attention": 4 * 2 * 2 * 2 * 32 * 48,
            "wkv6": 5 * 16 * 16 * 3 * 2 * 20,
            "mamba_scan": (7 * 8 + 10) * 16 * 2 * 20}[name]
    assert counter.get_total_flops() == want


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "wkv6", "mamba_scan"])
def test_counter_puts_each_kernels_flops_at_its_dtype(name):
    """The counter files a kernel's flops under the dtype it computes in:
    the attention kernels' inputs' (bf16 here, on the tensor cores), the
    recurrences' fp32, the Mamba scan's too although its inputs are
    bf16."""
    wrapper, _, args = _cases(np.random.default_rng(0))[name]
    counter = roofline.RooflineCounter()
    with counter:
        wrapper(*_meta(args))
    got = counter.take()
    want = "float32" if name in ("wkv6", "mamba_scan") else "bfloat16"
    assert list(got.flops_by_dtype) == [want]
    assert got.flops_by_region == {name: got.counts.flops}


def test_counter_counts_a_prefill_by_hand():
    """Reduced qwen3-8b's prefill on meta tensors, on one device: the
    matrix products are 2 flops a layer weight a token and the LM head's
    for the last token, the attention the operator's visible pairs; the
    kernel launches once a layer; every byte counted is positive and the
    plain bodies move more than the kernels."""
    cfg = get_arch("qwen3-8b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, "meta")
    b, s = 3, 40
    counter = roofline.RooflineCounter()
    counter.resident(params)
    with torch.no_grad(), counter:
        prefill(params, cfg, {"tokens": torch.zeros(
            (b, s), dtype=torch.long, device="meta")})
    d, hd, L = cfg.d_model, cfg.hd, cfg.n_layers
    layer = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd \
        + cfg.n_heads * hd * d + 3 * d * cfg.d_ff
    dense = 2 * L * layer * b * s + 2 * d * cfg.vocab_size * b
    attn = L * 4 * b * cfg.n_heads * hd * s * (s + 1) // 2
    assert counter.flops_by_region == {"dense": dense,
                                       "flash_attention": attn}
    assert counter.kernels["flash_attention"]["calls"] == L
    assert counter.counts.hbm_bytes > 0
    assert counter.counts.kernel_region_bytes > 0
    assert counter.peak_bytes > 0 and counter.counts.link_bytes == 0


# ------------------------------------------------ 4: cells on a fake mesh
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reduced_family_cell_on_a_fake_mesh(family, kind):
    """One reduced arch per family, grad_accum 2 as JAX's test: the cell
    runs on meta DTensors to status ok, every kernel of its path counted,
    and the mesh's 8 ranks divide the per-device flops."""
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    arch = FAMILIES[family]
    cfg = dataclasses.replace(get_arch(arch).reduced(), grad_accum=2)
    row = dryrun.run_cell(arch, KINDS[kind], mesh, "2x4", verbose=False,
                          arch_override=cfg)
    assert row["status"] == "ok", row
    assert row["n_devices"] == 8 and row["hlo_flops_per_dev"] > 0
    assert row["hbm_bytes_per_dev"] > 0 and row["link_bytes_per_dev"] > 0
    want = {"wkv6"} if cfg.attn_free else \
        {"decode_attention" if kind == "decode" else "flash_attention"}
    if cfg.hybrid_ssm:
        want.add("mamba_scan")
    assert set(row["kernel_calls"]) == want
    if kind == "train":
        assert row["microbatches_counted"] == 2


def test_dense_cell_flops_hold_jax_to_one_percent(jax_flops):
    """Per-device matrix-product flops of one dense train cell on the
    (2, 4) mesh, against JAX's compiled program (``analyze_hlo``'s dot
    count, looped by its trip counts). Two differences are taken out,
    each counted from the shapes:
    * attention: the reference's dots run over all S x S scores (its
      batched dots), the port's kernel over the visible pairs (the
      ``flash_attention`` operator and its backward's region);
    * the LM head's forward again in the backward: the port recomputes
      each loss chunk (``checkpoint``), JAX's scan keeps its logits."""
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    cfg = dataclasses.replace(get_arch(FLOPS_ARCH).reduced(), n_kv_heads=4,
                              grad_accum=FLOPS_ACCUM)
    shape = ShapeConfig("t", "train", 64, 8)
    row = dryrun.run_cell(FLOPS_ARCH, shape, mesh, "2x4", verbose=False,
                          arch_override=cfg)
    recompute = 2 * (shape.global_batch // 2) * shape.seq_len \
        * cfg.d_model * (cfg.vocab_size // 4)
    mine = row["flops_by_region"]["dense"] - recompute
    out, err = jax_flops.communicate(timeout=600)
    line = [x for x in out.splitlines() if x.startswith("FLOPS ")]
    assert line, err[-3000:]
    theirs = json.loads(line[0].split(" ", 1)[1])
    assert theirs["total"] == theirs["plain"] + theirs["batched"]
    assert abs(mine - theirs["plain"]) <= 0.01 * theirs["plain"], \
        (mine, theirs)


@pytest.mark.parametrize("arch", ["arctic-480b", "hymba-1.5b"])
def test_undivided_dims_stay_whole_against_jaxs_gspmd(arch):
    """At full width on the (16, 16) mesh, decode_32k: arctic's 56 heads
    and 8 KV heads, hymba's 25 and 5 and its 1600 Mamba channels (100 a
    rank, not a multiple of the scan's 8) are whole on every ``model``
    rank in the port. The row states JAX's placement as GSPMD's rule,
    over gcd(dim, 16) ranks, and whether the port's matches it: only
    where the gcd is 1 (hymba's heads). The rule itself is observed in
    JAX's compiled dry run by ``tests/test_torch_reference_placements.py::
    test_reference_dry_run_shards_over_the_gcd``."""
    mesh = make_fake_mesh((16, 16), ("data", "model"))
    row = dryrun.run_cell(arch, "decode_32k", mesh, "16x16", verbose=False)
    got = row["undivided_dims"]
    cfg = get_arch(arch)
    want = {f"n_heads={cfg.n_heads}", f"n_kv_heads={cfg.n_kv_heads}"}
    if cfg.hybrid_ssm:
        want.add(f"mamba_channels={cfg.n_heads * cfg.hd}")
    assert set(got) == want
    for name, dim in got.items():
        whole = int(name.split("=")[1])
        assert dim["per_rank"] == whole, name
        assert dim["placement"] == "replicated over model"
        ways = np.gcd(whole, 16)
        assert dim["jax"] == ("replicated over model" if ways == 1
                              else f"sharded {ways} ways"), name
        assert dim["matches_jax"] == (ways == 1), name


def test_main_writes_rows_that_roofline_bench_reads(tmp_path, capsys):
    """The CLI writes one row per cell where ``--out`` says, and
    ``benchmarks/roofline_bench.py:load_rows`` reads them unedited; a
    cell that does not apply is skipped with JAX's reason."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.roofline_bench import load_rows
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    rows = {r["shape"]: r for r in load_rows(str(tmp_path))}
    jd = _jax_dryrun()
    assert rows["long_500k"]["status"] == "skipped"
    assert rows["long_500k"]["reason"] == jd.shape_applicable(
        JAX_ARCHS["qwen2.5-3b"], JAX_SHAPES["long_500k"])[1]
    row = rows["decode_32k"]
    assert row["status"] == "ok" and row["xla_cost_flops_uncorrected"] is None
    assert row["arg_bytes"] > 0 and row["temp_bytes"] > 0
    from repro_torch.launch.mesh import PEAK_FLOPS_BY_DTYPE
    assert row["compute_typed_s"] == roofline.per_dtype_compute_s(
        row["flops_by_dtype"], PEAK_FLOPS_BY_DTYPE)
    assert row["bound_typed_s"] == max(row["compute_typed_s"],
                                       row["memory_s"], row["collective_s"])
    assert "1 ok, 0 skipped" in capsys.readouterr().out
