"""A model family plugs into the benchmark through files of its own
(`bench.reference.spec`): a family defined here, outside the benchmark's
files and registered through the same lookup, runs through the decode,
prefill and training drivers and the port, and is judged by its own
reference; a leaf
it adds leaves the benchmark's leaves as they were; the benchmark's own
families keep their weights, reference outputs and counts bit for bit; and
no driver or harness module names a family."""
import dataclasses
import hashlib
import importlib
import re
import types

import pytest
import torch

from bench.harness import common as C
from bench.harness import weights as WT
from bench.reference import model as R
from bench.reference import spec as SP
from bench.reference.spec import load_spec
from bench.tests import family_sigmoid as FAM
from bench.tests import tiny
from bench.yardstick import kernels as YK
from bench.yardstick import work as YW

CELL = {"decode": "deepseek-v2-l4.decode-w8",
        "prefill": "deepseek-v2-l4.prefill-long",
        "train": "phi3.5-moe-l2.train-4x4096"}


def register(monkeypatch, fam=FAM):
    monkeypatch.setitem(SP.FAMILIES, FAM.MODEL_TYPE, fam)


def run(kind, **kw):
    s = SP.parse(FAM.CONFIG, "tiny-sigmoid")
    drv = importlib.import_module(f"bench.drivers.{kind}")
    return drv.run(tiny.context(kind, spec=s, **kw))


@pytest.mark.parametrize("kind", sorted(CELL))
def test_a_family_of_new_files_runs_and_is_correct(monkeypatch, kind):
    register(monkeypatch)
    s = SP.parse(FAM.CONFIG, "x")
    assert isinstance(s, FAM.SigmoidSpec) and s.model_type == FAM.MODEL_TYPE
    # the port runs the family's router, and the family's leaf is drawn
    from bench.harness import program
    assert program.arch(s).moe.router_softmax is False
    assert FAM.BIAS in {leaf.name for leaf in WT.leaves(s)}
    out = run(kind, control=True)
    assert C.judge(out.checks, C.limits(CELL[kind])), out.checks
    assert any(out.control[k] > 10 * max(out.checks[k], 1e-6)
               for k in out.checks), (out.checks, out.control)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_the_check_reads_the_familys_reference(monkeypatch, kind):
    """Without its reference (softmax routing in the reference, sigmoid in
    the port) the family's runs read far above its sound runs, and prefill
    is not correct. A window of 0 s serves one request (one wave), so the
    same ones are checked each time."""
    without = types.SimpleNamespace(
        **{k: v for k, v in vars(FAM).items() if k != "Model"})
    register(monkeypatch)
    sound = run(kind, seconds=0.0).checks
    register(monkeypatch, without)
    assert type(R.reference(SP.parse(FAM.CONFIG, "x"), None)) is R.Model
    off = run(kind, seconds=0.0).checks
    assert all(off[k] > 100 * max(sound[k], 1e-4) for k in off), (sound,
                                                                   off)
    if kind == "prefill":
        assert not C.judge(off, C.limits(CELL[kind])), off


def test_an_added_leaf_leaves_every_default_leaf_as_it_was(monkeypatch):
    register(monkeypatch, types.SimpleNamespace(spec=FAM.spec,
                                                leaves=FAM.add_bias))
    seed = 2 ** 33 + 5
    base = tiny.GQA_MOE
    fam = SP.parse(FAM.CONFIG, base.name)
    a, b = WT.make(base, seed, "cpu"), WT.make(fam, seed, "cpu")
    assert set(b) - set(a) == {FAM.BIAS}
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert b[FAM.BIAS].dtype == torch.float32 and b[FAM.BIAS].abs().sum() > 0
    assert not torch.equal(b[FAM.BIAS],
                           WT.make(fam, seed + 1, "cpu")[FAM.BIAS])
    assert WT.param_count(fam) == WT.param_count(base) + b[FAM.BIAS].numel()


# -- the benchmark's own families, bit for bit as before the lookup ----------

def _sha(parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else repr(p).encode())
    return h.hexdigest()[:16]


def _bytes(t) -> bytes:
    return t.detach().contiguous().numpy().tobytes()


def counts(s, B, ctx, L) -> str:
    return _sha([
        WT.param_count(s), [tuple(leaf)[:4] for leaf in WT.leaves(s)],
        YW.body_params(s), YW.forward_flops(s, L, 1), YW.train_flops(s, 2, L),
        YW.prefill_flops(s, L), YW.decode_flops(s, B, ctx),
        YW.decode_bytes(s, B, ctx, 8), YW.decode_bytes(s, B, ctx, 4),
        YW.cache_bytes_per_pos(s), YK.k2_products(s),
        YK.k2_step_bound_s(s, B), YK.k5_forward_bound_s(s, 1, L),
        YK.k5_backward_bound_s(s, 2, L)])


def model_digests(s) -> dict:
    """Digests of the seeded weights; of the reference's logits, aux and
    routing margins over two sequences, from float32 weights, on the 8-
    and 4-bit grids and with float8 products; and of its training loss and
    gradients. On one thread, so every sum runs in one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        w = WT.make(s, 3_400_000_019, "cpu")
        out = {"weights": _sha(k.encode() + _bytes(t) for k, t in w.items())}
        tok = torch.randint(0, s.vocab_size, (2, 24),
                            generator=torch.Generator().manual_seed(7))
        f32 = R.weight_fetch(w, {}, 8, "cpu")
        with torch.no_grad():
            for tag, fetch, prec in (
                    ("f32", f32, None),
                    ("w8", R.weight_fetch(w, R.scales_of(w, 8), 8, "cpu"),
                     None),
                    ("w4", R.weight_fetch(w, R.scales_of(w, 4), 4, "cpu"),
                     None),
                    ("fp8", f32, R.Precision("fp8"))):
                m = R.reference(s, fetch, prec)
                h, aux = m.hidden(tok)
                out[tag] = _sha([_bytes(m.logits(h)), _bytes(aux)]
                                + [_bytes(x) for x in m.margins])
        p = {k: t.float().requires_grad_(True) for k, t in w.items()}

        def fetch(name, *index):
            t = p[name]
            for i in index:
                t = t[i]
            return t

        m = R.reference(s, fetch, grad=True)
        h, aux = m.hidden(tok)
        loss = R.next_token_loss(m, h, tok, aux)
        g = torch.autograd.grad(loss, list(p.values()))
        out["train"] = _sha([_bytes(loss)] + [_bytes(x) for x in g])
        return out
    finally:
        torch.set_num_threads(threads)


# read before the family lookup existed (torch on the CPU, one thread)
PINNED = {
    "tiny-mla-moe": {
        "weights": "00d57e3e5404a21a", "f32": "09eda34b9774ed98",
        "w8": "83c54617b8d9097e", "w4": "81fc661eb957c6ee",
        "fp8": "edf9d40c9ef8d83c", "train": "25e567b05a8f6b26",
        "counts": "8dd801a1a7b0111c"},
    "tiny-gqa-moe": {
        "weights": "21dcf4d0329c9fd3", "f32": "1b2a659781a180e8",
        "w8": "04175c01bafa9c09", "w4": "1ca39a4c1d796a9b",
        "fp8": "68975891bb6457ff", "train": "76f7ca24666f8c24",
        "counts": "dd93484b28d757a4"},
    "tiny-mla-moe-w8": {
        "weights": "efe020b567d71c1d", "f32": "747acaad4fdf300a",
        "w8": "6f91d666c40796d1", "w4": "bbf329482d489063",
        "fp8": "bcba97aa0af34ff6", "train": "2f6718d0e5fb7538",
        "counts": "f957295bd86bffb8"},
    "deepseek-v2-l4": {"counts": "d4243794211bc4a1"},
    "phi3.5-moe-l2": {"counts": "f0a4d4e4e70545ff"},
    "phi3.5-moe-l8": {"counts": "8b637e0c55592ccf"},
}
TINY = {s.name: s for s in (tiny.MLA_MOE, tiny.GQA_MOE, tiny.MLA_MOE_W8)}


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_specs_as_pinned(name):
    s = TINY[name]
    got = dict(model_digests(s), counts=counts(s, 6, 36.5, 40))
    assert got == PINNED[name]


@pytest.mark.parametrize("name", ["deepseek-v2-l4", "phi3.5-moe-l2",
                                  "phi3.5-moe-l8"])
def test_the_cells_counts_as_pinned(name):
    s = load_spec(name)
    assert counts(s, 128, 4096 + 64.5, 4096) == PINNED[name]["counts"]


# -- nothing but a family's own files names it --------------------------------

def model_types():
    names = {p.stem[len("family_"):]
             for p in (C.BENCH / "reference").glob("family_*.py")}
    return names | {SP.load_config(c["name"])["model_type"]
                    for c in C.manifest()["configs"]}


SHARED = sorted(p for d in ("drivers", "harness", "yardstick")
                for p in (C.BENCH / d).glob("*.py")
                if not p.name.startswith("family_"))


@pytest.mark.parametrize("path", SHARED,
                         ids=[str(p.relative_to(C.BENCH)) for p in SHARED])
def test_no_shared_module_names_a_family(path):
    text = path.read_text()
    for mt in model_types():
        assert not re.search(rf"\b{re.escape(mt)}\b", text), (path, mt)
    assert "R.Model(" not in text and "R.Model (" not in text


def test_the_benchmarks_families_keep_the_default_parts():
    s = load_spec("deepseek-v2-l4")
    assert s.model_type == "deepseek_v2" and type(s) is SP.ModelSpec
    assert SP.family("deepseek_v2", "harness") is None
    assert SP.part(s, "harness", "arch", None) is None
    assert type(R.reference(s, None)) is R.Model
    assert WT.leaves(s) == WT.leaves.default(s)
    assert dataclasses.replace(s, model_type="") == dataclasses.replace(
        load_spec("deepseek-v2-l4"), model_type="")
    with pytest.raises(ValueError):
        SP.parse({"model_type": "no_such_family"}, "x")
