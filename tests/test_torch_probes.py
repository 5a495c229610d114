"""The port's probes P1-P3 and its probe tool, on the CPU: the plain
versions of ``ops/probe_mma.py`` against ``jax.lax.dot`` /
``dot_general`` with the Pallas bodies' dimension numbers and
``preferred_element_type`` (the JAX tool's ``tools/probe_layer_kernel.py``
:406-631) on the same ``np.random.default_rng(0)`` inputs at the probes'
shapes; the wrappers' argument checks; and the port's tool, whose probes
and step timings run here on the plain versions.

The JAX tool itself is not imported: it sets JAX's global compilation
cache at import. P1 and the transposes are exact; every other case holds
2e-5 of the reference's largest magnitude (the same products summed in
another order).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_apr_tpu_torch.ops import probe_mma as pm
from whisper_apr_tpu_torch.tools import probe_layer_kernel as tool
from whisper_apr_tpu_torch.tools.profile_decode import P, stepped, timeit

TOL = 2e-5
DN_T = (((0,), (0,)), ((), ()))          # transposed LHS (contract dim 0)
DN_B = (((2,), (1,)), ((0,), (0,)))      # batched [B, bt, D] . [B, D, H]
DN_BT = (((1,), (1,)), ((0,), (0,)))     # batched, contracting bt


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return np.asarray(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
    return t.numpy()


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _f32(preferred=jnp.float32):
    return dict(preferred_element_type=preferred)


# the Pallas body of each case (the JAX tool's kernels), on its inputs
JAX_BODIES = {
    "P1": lambda a, b: jax.lax.dot(a, b, **_f32(jnp.int32)),
    "P2": lambda a, b: jax.lax.dot(a, b, **_f32()),
    "P3 (a)": lambda a, b: jax.lax.dot_general(a, b, DN_T, **_f32()),
    "P3 (b)": lambda a, b: jax.lax.dot_general(a, b, DN_T, **_f32()),
    "P3 (c)": lambda a, b: jax.lax.dot(a, b, **_f32()),
    "P3 (d)": lambda a: jnp.transpose(a),
    "P3 (e)": lambda a, b: jax.lax.dot_general(a, b, DN_T, **_f32()),
    "P3 (f)": lambda a, b: jax.lax.dot(a, b, **_f32()),
    "P3 (g)": lambda a, b: jax.lax.dot_general(a, b, DN_B, **_f32()),
    "P3 (h)": lambda a, b: jax.lax.dot_general(a, b, DN_BT, **_f32()),
    "P3 (i)": lambda a, b: jax.lax.dot(a.astype(jnp.bfloat16), b,
                                       **_f32()),
    "P3 (j)": lambda a, b: jax.lax.dot_general(a, b, DN_T, **_f32()),
}

CASES = tool.int8dot_cases("cpu") + tool.tricks_cases("cpu")


@pytest.mark.parametrize("case", CASES, ids=[f"{c.probe} {c.name}"
                                             for c in CASES])
def test_plain_matches_jax(case):
    want = np.asarray(JAX_BODIES[case.probe](
        *(jnp.asarray(_np(t)) for t in case.inputs)))
    got = case.plain()
    assert got.dtype == (torch.int32 if case.probe == "P1"
                         else torch.float32)
    assert tuple(got.shape) == want.shape
    if case.exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert _rel(got.numpy(), want) <= TOL


def test_inputs_are_the_jax_tools():
    """The draws of ``np.random.default_rng(0)`` in the JAX tool's
    order (tricks_probe: p_f, v8, qe, q_row, k8b, qeb, pb, v8b)."""
    rng = np.random.default_rng(0)
    p_f = rng.normal(0, 1, (128, 32)).astype(np.float32)
    v8 = rng.integers(-127, 128, (128, 1280), dtype=np.int8)
    qe = rng.normal(0, 1, (1280, 32)).astype(np.float32)
    q_row = rng.normal(0, 1, (8, 1280)).astype(np.float32)
    k8b = rng.integers(-127, 128, (8, 128, 1280), dtype=np.int8)
    by = {c.probe: c for c in tool.tricks_cases("cpu")}
    np.testing.assert_array_equal(by["P3 (e)"].inputs[0].numpy(), p_f)
    np.testing.assert_array_equal(by["P3 (e)"].inputs[1].numpy(), v8)
    np.testing.assert_array_equal(by["P3 (c)"].inputs[1].numpy(), qe)
    np.testing.assert_array_equal(
        tool.tricks_cases("cpu")[3].inputs[0].numpy(), q_row)
    np.testing.assert_array_equal(by["P3 (g)"].inputs[0].numpy(), k8b)


def test_int8_plain_is_exact_at_the_extremes():
    """All -127 against all 127 over K = 256: -4 129 024, exact in
    float64 and in int32."""
    a = torch.full((16, 256), -127, dtype=torch.int8)
    b = torch.full((256, 8), 127, dtype=torch.int8)
    out = pm.int8_dot(a, b)
    assert out.dtype == torch.int32
    assert int(out.min()) == int(out.max()) == -127 * 127 * 256


def test_cast_a_rounds_to_bf16_first():
    """Sub-probe (i): an f32 value between two bf16 neighbours contracts
    as its bf16 rounding."""
    a = torch.full((1, 1), 1.0 + 2.0 ** -9, dtype=torch.float32)
    b = torch.ones((1, 1), dtype=torch.int8)
    assert float(pm.tricks_dot(a, b, cast_a_bf16=True)) == 1.0
    assert float(pm.tricks_dot(a, b)) == 1.0 + 2.0 ** -9


@pytest.mark.parametrize("call,err", [
    (lambda: pm.int8_dot(torch.zeros(2, 3), torch.zeros(3, 2)), TypeError),
    (lambda: pm.mixed_dot(torch.zeros(2, 3, dtype=torch.int8),
                          torch.zeros(3, 2)), TypeError),
    (lambda: pm.tricks_dot(torch.zeros(2, 3, dtype=torch.bfloat16),
                           torch.zeros(3, 2)), TypeError),
    (lambda: pm.tricks_dot(torch.zeros(2, 3, dtype=torch.int8),
                           torch.zeros(3, 2, dtype=torch.int8),
                           cast_a_bf16=True), TypeError),
    (lambda: pm.tricks_transpose(torch.zeros(2, 3, dtype=torch.int8)),
     ValueError),
], ids=["int8_dot f32", "mixed_dot f32 rhs", "bf16 . f32", "cast int8",
        "transpose int8"])
def test_wrappers_refuse_other_dtypes(call, err):
    with pytest.raises(err):
        call()


@pytest.mark.parametrize("a_shape,b_shape,trans_a", [
    ((2, 3), (4, 5), False), ((3, 2), (4, 5), True),
    ((2, 2, 3), (3, 3, 4), False), ((2, 3), (1, 3, 4), False)])
def test_wrappers_refuse_mismatched_shapes(a_shape, b_shape, trans_a):
    with pytest.raises(ValueError):
        pm.tricks_dot(torch.zeros(a_shape), torch.zeros(b_shape), trans_a)


# ragged shapes of the f32 contraction: (batch, M, K, N, trans_a, a dtype,
# b dtype)
RAGGED = [(1, 33, 1281, 33, False, "f32", "f32"),
          (1, 33, 1281, 33, True, "int8", "f32"),
          (1, 33, 1281, 65, False, "f32", "int8"),
          (3, 65, 1281, 33, True, "f32", "int8"),
          (3, 33, 200, 65, False, "int8", "f32")]


def _operands(batch, M, K, N, trans_a, at, bt, seed=3):
    rng = np.random.default_rng(seed)

    def draw(shape, kind):
        if kind == "int8":
            return torch.from_numpy(rng.integers(-127, 128, shape,
                                                 dtype=np.int8))
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    lead = (batch,) if batch > 1 else ()
    return (draw(lead + ((K, M) if trans_a else (M, K)), at),
            draw(lead + (K, N), bt))


@pytest.mark.parametrize("shape", RAGGED, ids=[
    "K=1281 f32", "K=1281 int8T", "K=1281 N=65", "batch 3 T", "M=33 N=65"])
def test_ragged_plain_matches_jax(shape):
    """``tricks_dot_plain`` against ``jax.lax.dot_general`` where no
    chunk divides K and M, N are 33 or 65."""
    batch, M, K, N, trans_a = shape[:5]
    a, b = _operands(*shape)
    lead = int(batch > 1)                  # a leading batch axis
    dn = ((((0 if trans_a else 1) + lead,), (lead,)),
          ((0,), (0,)) if lead else ((), ()))
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), dn, **_f32()))
    got = pm.tricks_dot(a, b, trans_a)
    assert tuple(got.shape) == want.shape == (
        ((batch,) if batch > 1 else ()) + (M, N))
    assert _rel(got.numpy(), want) <= TOL


# shapes whose plans cover each path of the kernel: the probes' (a), (c),
# (g), (h), (j), the ragged ones, a grid of over 132 tiles whose K
# streams through the ring, and large outputs
PLAN_SHAPES = [(1, 32, 128, 1280, True, 4, 4), (1, 128, 1280, 32, False, 1, 4),
               (8, 128, 1280, 32, False, 1, 4), (8, 32, 128, 1280, True, 4, 1),
               (1, 1280, 128, 32, True, 1, 4), (1, 33, 1281, 65, False, 4, 4),
               (3, 65, 1281, 33, True, 1, 4), (1, 264, 640, 1056, False, 4, 1),
               (1, 256, 601, 1088, False, 4, 4), (1, 1, 1, 1, False, 4, 4),
               (1, 4096, 4096, 4096, False, 4, 4), (2, 7, 100000, 5, True, 1, 4)]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=[str(s[:4]) for s in PLAN_SHAPES])
def test_dot_plan_covers_k_once(shape):
    """Every K index in exactly one split; splits a multiple of 64 (16-byte
    aligned panels), between 1 and the cap, none empty; the tile one the
    kernel has; the stages within the kernel's shared memory."""
    batch, M, K, N, trans_a, a_size, b_size = shape
    plan = pm.dot_plan(*shape)
    assert (plan.bm, plan.bn, plan.k_groups) in {
        (32, 64, 1), (64, 32, 1), (32, 32, 1), (32, 32, 2)}
    assert 1 <= plan.n_split <= pm.DOT_MAX_SPLITS
    ranges = plan.k_ranges(K)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(s < e for s, e in ranges)
    for (_, end), (start, _) in zip(ranges, ranges[1:]):
        assert end == start
    if plan.n_split > 1:
        assert plan.k_split % pm.DOT_SPLIT_ALIGN == 0
    assert plan.k_chunk % 16 == 0
    assert plan.k_chunk // plan.k_groups % 4 == 0   # a group's k steps
    stages = 1 if plan.k_chunk >= min(K, plan.k_split) else 2
    assert stages * pm.dot_stage_bytes(plan.bm, plan.bn, plan.k_chunk,
                                       trans_a, a_size, b_size) \
        <= pm.DOT_SMEM


def test_dot_plan_at_the_probes():
    """(a): 40 tiles of 32 x 32, K = 128 whole in one stage, two thread
    groups a block; (c) and (g): K = 1280 split over blocks in 20 ranges
    of 64 (on 4 and 32 tiles); (h): 160 tiles of 32 x 64, no split."""
    assert pm.dot_plan(1, 32, 128, 1280, True) == pm.DotPlan(32, 32, 2, 1,
                                                             128, 128)
    for batch in (1, 8):
        assert pm.dot_plan(batch, 128, 1280, 32, False, 1, 4) == pm.DotPlan(
            32, 32, 1, 20, 64, 64)
    assert pm.dot_plan(8, 32, 128, 1280, True, 4, 1) == pm.DotPlan(
        32, 64, 1, 1, 128, 128)


def test_launch_counts_only_on_the_card():
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    pm.reset_launches()
    for c in CASES:
        c.kernel()
    assert pm.LAUNCHES == {"int8_dot": 0, "mixed_dot": 0, "tricks": 0}


class TestTool:
    """The port's probe tool on the CPU (plain versions, host times)."""

    def test_probes_pass(self, tmp_path, capsys):
        out = tool.main(["--int8dot", "--tricks", "--device", "cpu",
                         "--json", str(tmp_path / "r.json")])
        names = [p["name"] for p in out["probes"]]
        assert names == [c.name for c in CASES]
        assert all(p["runs"] and p["passed"] for p in out["probes"])
        assert all(p["us"] is None for p in out["probes"])
        assert json.loads((tmp_path / "r.json").read_text()) == out
        text = capsys.readouterr().out
        assert all(n in text for n in names)
        assert json.loads(text.strip().splitlines()[-1]) == {
            "launches": out["launches"]}

    def test_steps_run_at_small_width(self):
        out = tool.main(["--large", "--anatomy", "--anatomy-layers", "1,2",
                         "--batched", "--b", "2", "--model", "tiny",
                         "--lo", "1", "--hi", "2", "--device", "cpu"])
        assert set(out["steps_ms"]) >= {"qf", "L1", "L2", "per_layer",
                                        "fixed", "b2_int8"}
        assert all(np.isfinite(v) for v in out["steps_ms"].values())

    @pytest.mark.parametrize("flags,key", [
        (["--q4k", "--fused"], "q4k_fused"), (["--q5k"], "q5k_scan"),
        (["--batched", "--b", "2", "--quant", "q6k"], "b2_q6k")])
    def test_kquant_steps(self, flags, key):
        cfg = tool.ModelConfig.base()
        small = tool.dataclasses.replace(cfg, n_text_layer=1, n_vocab=600)
        assert small.n_text_state % 256 == 0
        fn = {"q4k_fused": lambda: tool.kq_measure(1, 2, "cpu", small, "q4k",
                                                   True),
              "q5k_scan": lambda: tool.kq_measure(1, 2, "cpu", small, "q5k"),
              "b2_q6k": lambda: tool.batched_measure(1, 2, "cpu", small, 2,
                                                     "q6k")}[key]
        assert np.isfinite(fn()[key])

    def test_which_takes_qf_only(self):
        with pytest.raises(ValueError, match="only qf"):
            tool.large_measure(1, 2, "cpu", tool.ModelConfig.tiny(),
                               which=("qf_defer",))

    def test_needs_a_stage(self):
        with pytest.raises(SystemExit):
            tool.main(["--device", "cpu"])

    def test_cuda_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            tool.main(["--int8dot"])


class TestProfileDecode:
    """The slope timer and its helpers."""

    def test_stepped_runs_the_body_in_order(self):
        seen = []
        out = stepped(lambda i, env, s: seen.append(i) or s + env)(4, 2, 1)
        assert out == 9 and seen == [0, 1, 2, 3]

    def test_per_step_is_the_slope(self, monkeypatch):
        """A fake clock that advances 5 per step and 7 per run: the slope
        is 5."""
        import whisper_apr_tpu_torch.tools.profile_decode as pd
        now = [0.0]

        def body(i, env, s):
            now[0] += 5.0
            return s

        def clock():
            now[0] += 3.5      # two reads a timed run: 7 of fixed cost
            return now[0]
        monkeypatch.setattr(pd.time, "perf_counter", clock)
        assert P(2, 6, "cpu").per_step(body, None, None) == pytest.approx(5.0)

    def test_timeit_is_the_best_run(self):
        calls = []
        assert timeit(lambda: calls.append(1), reps=3, device="cpu") >= 0
        assert len(calls) == 4       # one warm-up and three timed

    def test_lo_below_hi(self):
        with pytest.raises(ValueError):
            P(4, 4)


# P1 off the probe's 256^3 (the kernel's tiles and K chunks are ragged at
# these): the plain version against jax.lax.dot with an int32 result
INT8_RAGGED = [(1, 32, 8), (100, 200, 300), (33, 1281, 65), (1, 1, 1),
               (129, 257, 130), (7, 4096, 9)]


@pytest.mark.parametrize("shape", INT8_RAGGED,
                         ids=["x".join(map(str, s)) for s in INT8_RAGGED])
def test_int8_plain_matches_jax_at_ragged_shapes(shape):
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    b = rng.integers(-127, 128, (K, N), dtype=np.int8)
    want = np.asarray(jax.lax.dot(jnp.asarray(a), jnp.asarray(b),
                                  **_f32(jnp.int32)))
    got = pm.int8_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)


INT8_PLAN_K = [256, 32, 1, 200, 1281, 257, 64, 1024, 4096, 33, 16, 255]


@pytest.mark.parametrize("K", INT8_PLAN_K)
def test_int8_plan_covers_k_once(K):
    """The K that P1 stages at a time: a multiple of 32 (one m16n8k32
    step); whole up to 256, else 128-deep chunks; the chunks cover every
    K index once, the last not empty."""
    k_chunk = pm.int8_plan(K)
    assert k_chunk % 32 == 0
    assert k_chunk == (32 * math.ceil(K / 32) if K <= pm.I8_PANEL_K
                       else pm.I8_RING_K)
    n_chunks = math.ceil(K / k_chunk)
    ranges = [(k, min(K, k + k_chunk)) for k in range(0, K, k_chunk)]
    assert len(ranges) == n_chunks and ranges[-1][0] < K
    assert sorted(i for s, e in ranges for i in range(s, e)) \
        == list(range(K))


def test_int8_plan_at_the_probe():
    """256^3: the 256-deep panel staged whole, behind one barrier."""
    assert pm.int8_plan(256) == 256


@pytest.mark.parametrize("shape", [(256, 256, 256), (100, 200, 300)])
def test_int8_dot_one_launch(monkeypatch, shape):
    """``int8_dot``'s CUDA path makes one call of the C entry point with
    the K chunk and the stream, and counts one launch."""
    calls = []

    class Lib:
        def wa_probe_int8_mma(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(pm._build, "library", Lib)
    monkeypatch.setattr(pm._build, "stream", lambda: 9)
    monkeypatch.setattr(pm, "_check_cuda", lambda *ts: None)
    M, K, N = shape
    a = torch.zeros((M, K), dtype=torch.int8)
    b = torch.zeros((K, N), dtype=torch.int8)
    before = pm.LAUNCHES["int8_dot"]
    out = pm._int8_cuda(a, b)
    assert pm.LAUNCHES["int8_dot"] == before + 1 and len(calls) == 1
    assert calls[0][3:6] == (M, K, N)
    assert calls[0][6] == pm.int8_plan(K)
    assert calls[0][7] == 9 and len(calls[0]) == 8 and out.shape == (M, N)


def _byte_perm(x: int, y: int, s: int) -> int:
    """``__byte_perm(x, y, s)``: byte i of the result is byte (s >> 4i) & 7
    of the 8 bytes of y:x."""
    b = [(x >> 8 * i) & 0xFF for i in range(4)] \
        + [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(s >> 4 * i) & 7] << 8 * i for i in range(4))


def _transpose4x4(w):
    """csrc ``transpose4x4``: w[i] holds bytes (i, 0..3); o[j] (0..3, j)."""
    t0, t1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[2], w[3], 0x5140)
    t2, t3 = _byte_perm(w[0], w[1], 0x7362), _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def test_int8_fragments_mirror():
    """P1's fragment plumbing in numpy: for one warp tile (16 x 32, one
    32-deep step) lane (g, t) loads A's words as the m16n8k32 layout asks
    and one word of B [k][n] at column 4g from rows 4t .. 4t + 3 (and 16
    + ...), transposed by ``transpose4x4`` into the B fragments of the
    four n-tiles, whose mma column g stands for column 4g + nt; the
    sums, stored at columns 8t .. 8t + 7 as the kernel stores them, are
    A . B."""
    rng = np.random.default_rng(5)
    A = rng.integers(-127, 128, (16, 32)).astype(np.int8)
    B = rng.integers(-127, 128, (32, 32)).astype(np.int8)
    a_u, b_u = A.view(np.uint8).reshape(-1), B.view(np.uint8).reshape(-1)

    def word(buf, off):
        return int.from_bytes(bytes(buf[off:off + 4]), "little")

    def signed(w):
        return np.array([np.int8(np.uint8((w >> 8 * i) & 0xFF))
                         for i in range(4)], np.int64)

    out = np.zeros((16, 32), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a = [word(a_u, g * 32 + 4 * t), word(a_u, (g + 8) * 32 + 4 * t),
             word(a_u, g * 32 + 16 + 4 * t),
             word(a_u, (g + 8) * 32 + 16 + 4 * t)]
        assert [signed(w).tolist() for w in a] == [
            A[g, 4 * t:4 * t + 4].tolist(), A[g + 8, 4 * t:4 * t + 4].tolist(),
            A[g, 16 + 4 * t:20 + 4 * t].tolist(),
            A[g + 8, 16 + 4 * t:20 + 4 * t].tolist()]
        b0 = _transpose4x4([word(b_u, (4 * t + i) * 32 + 4 * g)
                            for i in range(4)])
        b1 = _transpose4x4([word(b_u, (16 + 4 * t + i) * 32 + 4 * g)
                            for i in range(4)])
        for nt in range(4):
            assert signed(b0[nt]).tolist() == B[4 * t:4 * t + 4,
                                                4 * g + nt].tolist()
            assert signed(b1[nt]).tolist() == B[16 + 4 * t:20 + 4 * t,
                                                4 * g + nt].tolist()
    # mma: C[row, j] of n-tile nt sums A[row, :] . B[:, 4 j + nt]; lane
    # (g, t) holds j = 2t, 2t + 1 of rows g and g + 8
    A64, B64 = A.astype(np.int64), B.astype(np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for row in (g, g + 8):
            acc = [[A64[row] @ B64[:, 4 * j + nt] for j in (2 * t, 2 * t + 1)]
                   for nt in range(4)]
            out[row, 8 * t:8 * t + 8] = [acc[nt][0] for nt in range(4)] \
                + [acc[nt][1] for nt in range(4)]
    np.testing.assert_array_equal(out, A64 @ B64)


# P2 off the probe's 256^3: one element, K not a multiple of 16, K past
# one staged panel (the 2-stage ring), M and N of 33 and 65
MIXED_RAGGED = [(1, 1, 1), (33, 1281, 65), (65, 23, 33), (100, 257, 130),
                (7, 4096, 9), (40, 48, 1000)]


@pytest.mark.parametrize("shape", MIXED_RAGGED,
                         ids=["x".join(map(str, s)) for s in MIXED_RAGGED])
def test_mixed_plain_matches_jax_at_ragged_shapes(shape):
    """``mixed_dot``'s plain version against the JAX tool's P2 body,
    ``jax.lax.dot`` of int8 and bf16 with an f32 result."""
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    b = torch.from_numpy(rng.normal(0, 1, (K, N)).astype(
        np.float32)).to(torch.bfloat16)
    want = np.asarray(JAX_BODIES["P2"](jnp.asarray(_np(a)),
                                       jnp.asarray(_np(b))))
    got = pm.mixed_dot(a, b)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert _rel(got.numpy(), want) <= TOL


# (batch, M, K, N, trans_a, a size, b size): P2, P3 (b), (i), the ragged
# shapes, a batch, K past the panel in every element size, grids of 64
# tiles of 64 x 64 whose stages fit only in shallower chunks
MIXED_PLAN_SHAPES = [(1, 256, 256, 256, False, 1, 2),
                     (1, 32, 128, 1280, True, 2, 1),
                     (1, 32, 128, 1280, False, 4, 1),
                     (1, 33, 1281, 65, False, 1, 2), (1, 1, 1, 1, False, 1, 2),
                     (3, 96, 1280, 32, False, 1, 2),
                     (1, 256, 4096, 512, True, 4, 1),
                     (1, 512, 256, 512, False, 4, 2),
                     (1, 512, 300, 512, True, 4, 2),
                     (2, 300, 257, 700, True, 1, 1)]


@pytest.mark.parametrize("shape", MIXED_PLAN_SHAPES,
                         ids=[str(s[:5]) for s in MIXED_PLAN_SHAPES])
def test_mixed_plan_covers_k_once(shape):
    """P2's launch: a tile of 32, or of 64 where that still gives 64
    blocks; K chunks a multiple of 32 (two k16 steps, one a k group),
    whole where K fits one panel of at most 256, the chunks covering
    every K index once, the last not empty; the block's shared memory
    within 48 KB."""
    batch, M, K, N, trans_a, a_size, b_size = shape
    plan = pm.mixed_plan(*shape)
    blocks = lambda t: batch * math.ceil(M / t) * math.ceil(N / t)
    assert plan.tile == (64 if blocks(64) >= pm.MX_MIN_BLOCKS else 32)
    assert plan.k_chunk % 32 == 0
    whole = 32 * math.ceil(K / 32)
    assert plan.k_chunk == whole or (plan.k_chunk in pm.MX_RING_K
                                     and plan.k_chunk < K)
    ranges = [(k, min(K, k + plan.k_chunk))
              for k in range(0, K, plan.k_chunk)]
    assert ranges[-1][0] < K and sorted(
        i for s, e in ranges for i in range(s, e)) == list(range(K))
    assert pm.mixed_smem(plan, K, trans_a, a_size, b_size) <= pm.MX_SMEM


def test_mixed_plan_at_the_probes():
    """P2 at 256^3: 64 blocks of 32 x 32, K = 256 whole behind one
    barrier; P3 (b) and (i), 32 x 128 x 1280: 40 blocks of 32 x 32, K =
    128 whole."""
    assert pm.mixed_plan(1, 256, 256, 256) == pm.MixedPlan(32, 256)
    assert pm.mixed_plan(1, 32, 128, 1280, True, 2, 1) == pm.MixedPlan(
        32, 128)
    assert pm.mixed_plan(1, 32, 128, 1280, False, 4, 1) == pm.MixedPlan(
        32, 128)


@pytest.mark.parametrize("shape", [(256, 256, 256), (33, 1281, 65)])
def test_mixed_dot_one_launch(monkeypatch, shape):
    """``mixed_dot``'s CUDA path makes one call of the C entry point with
    its dims, the plan and the stream, and counts one launch."""
    calls = []

    class Lib:
        def wa_probe_mma_bf16(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(pm._build, "library", Lib)
    monkeypatch.setattr(pm._build, "stream", lambda: 9)
    monkeypatch.setattr(pm, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(pm, "_check_device", lambda a: None)
    M, K, N = shape
    a = torch.zeros((M, K), dtype=torch.int8)
    b = torch.zeros((K, N), dtype=torch.bfloat16)
    before = pm.LAUNCHES["mixed_dot"]
    out = pm._mma(a, b, False, (1, M, K, N))
    assert len(calls) == 1 and out.shape == (M, N)
    args = calls[0]
    assert len(args) == len(pm._build._SIGNATURES["wa_probe_mma_bf16"])
    assert args[6:10] == (1, M, K, N)
    assert args[10:12] == tuple(pm.mixed_plan(1, M, K, N, False, 1, 2))
    assert args[-1] == 9 and pm.LAUNCHES["mixed_dot"] == before


def _f32_bits(x: int) -> np.float32:
    return np.array([x], np.uint32).view(np.float32)[0]


def _i8_f32(ux: int, sel: int) -> np.float32:
    """csrc ``i8_f32``: byte ``sel & 3`` of ux (bytes ^ 0x80) as the low
    byte of the f32 2^23, less 2^23 + 128 in f32."""
    return _f32_bits(_byte_perm(ux, 0x4B000000, sel)) - np.float32(8388736)


def _hi_pair(lo: np.float32, hi: np.float32):
    """csrc ``hi_pair``: the f32s' high halves as a bf16 pair; returns the
    pair's two values."""
    w = _byte_perm(int(np.float32(lo).view(np.uint32)),
                   int(np.float32(hi).view(np.uint32)), 0x7632)
    return (float(_f32_bits((w & 0xFFFF) << 16)),
            float(_f32_bits(w & 0xFFFF0000)))


def _i8_pair(u: int):
    """csrc ``i8_pair``: int8 bytes 0 and 1 of u as a bf16 pair."""
    ux = u ^ 0x8080
    return _hi_pair(_i8_f32(ux, 0x7440), _i8_f32(ux, 0x7441))


def test_mixed_int8_pairs_exact():
    """P2's widening in numpy: every int8 value, in either byte of a pair
    (``i8_pair``, A's reader) and at every byte of two words (B's reader),
    comes out as the bf16 of that value, exactly."""
    vals = np.arange(256, dtype=np.uint8).view(np.int8)
    rng = np.random.default_rng(13)
    for v in vals:
        o = int(rng.integers(-128, 128))
        u = (int(v) & 0xFF) | (o & 0xFF) << 8
        assert _i8_pair(u) == (float(v), float(o))
        assert _i8_pair((o & 0xFF) | (int(v) & 0xFF) << 8) == (o, float(v))
        for j in range(4):
            we, wo = (int(w) for w in rng.integers(0, 2 ** 32, 2))
            we = we & ~(0xFF << 8 * j) | (int(v) & 0xFF) << 8 * j
            b = _hi_pair(_i8_f32(we ^ 0x80808080, 0x7440 | j),
                         _i8_f32(wo ^ 0x80808080, 0x7440 | j))
            assert b == (float(v), float(np.int8(np.uint8(
                (wo >> 8 * j) & 0xFF))))


def _ldmatrix(panel: np.ndarray, addrs, trans: bool):
    """``ldmatrix.x4`` (``.trans``) over a flat panel of 16-bit values:
    lane l gives row l % 8 of matrix l // 8 at ``addrs[l]``; lane (g, t)
    gets matrix i's (row g, columns 2t, 2t + 1), or with .trans (rows 2t,
    2t + 1, column g). Returns [lane][i] = (lo, hi)."""
    mats = [np.stack([panel[addrs[8 * i + r]:addrs[8 * i + r] + 8]
                      for r in range(8)]) for i in range(4)]
    out = []
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        out.append([(m[2 * t, g], m[2 * t + 1, g]) if trans
                    else (m[g, 2 * t], m[g, 2 * t + 1]) for m in mats])
    return out


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("tb", ["bf16", "int8"])
@pytest.mark.parametrize("ta", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("tile", [32, 64])
def test_mixed_fragments_mirror(tile, ta, tb, trans_a):
    """P2's kernel in numpy over one staged tile and one k16 step: the
    panels laid out as the kernel stages them (rows 16 bytes longer),
    each warp's fragments read by ``a_frag`` / ``b_frags``' addresses
    (``ldmatrix`` modelled; int8 through ``i8_pair`` and the word reader),
    multiplied as m16n8k16 lays its fragments out and stored as the
    kernel stores: every output equals A . B of the bf16 operands (f32 A
    rounded to nearest even)."""
    rng = np.random.default_rng(tile + len(ta) + 3 * len(tb) + trans_a)
    kc, WM = 32, tile // 16
    if ta == "int8":
        A = rng.integers(-128, 128, (tile, 16)).astype(np.int8)
        Av = A.astype(np.float64)
    else:
        Af = rng.normal(0, 1, (tile, 16)).astype(np.float32)
        Ab = torch.from_numpy(Af).to(torch.bfloat16)
        A = Af if ta == "f32" else Ab
        Av = Ab.double().numpy()
    if tb == "int8":
        B = rng.integers(-128, 128, (16, tile)).astype(np.int8)
        Bv = B.astype(np.float64)
    else:
        B = torch.from_numpy(rng.normal(0, 1, (16, tile)).astype(
            np.float32)).to(torch.bfloat16)
        Bv = B.double().numpy()
    asize = {"f32": 4, "bf16": 2, "int8": 1}[ta]
    bsize = 2 if tb == "bf16" else 1

    def vals(x):   # an operand's values as the kernel reads them
        return x.double().numpy() if isinstance(x, torch.Tensor) else x

    # the staged panels, flat, in elements
    ald = (tile if trans_a else kc) + 16 // asize
    a_rows = kc if trans_a else tile
    ap = np.zeros(a_rows * ald, np.float64 if ta != "int8" else np.int64)
    src = vals(A)
    for m in range(tile):
        for k in range(16):
            ap[(k * ald + m) if trans_a else (m * ald + k)] = src[m, k]
    bld = tile + 16 // bsize
    bp = np.zeros(kc * bld, np.float64 if tb == "bf16" else np.int64)
    for k in range(16):
        bp[k * bld:k * bld + tile] = vals(B)[k]

    def bf16_round(x):
        return float(torch.tensor(float(x)).to(torch.bfloat16).float())

    def u8(x):
        return int(x) & 0xFF

    out = np.full((tile, tile), np.nan)
    for rg in range(WM):
        r0 = 16 * rg
        # A fragments, [lane][reg] = (lo, hi)
        if ta == "bf16":
            addrs = [((lane & 7) + 8 * ((lane >> 3) >> 1)) * ald + r0
                     + 8 * ((lane >> 3) & 1) if trans_a
                     else (r0 + (lane & 15)) * ald + 8 * (lane >> 4)
                     for lane in range(32)]
            af = _ldmatrix(ap, addrs, trans_a)
        else:
            af = []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                regs = []
                for j in range(4):
                    if trans_a:
                        q = (2 * t) * ald + r0 + g + 8 * (j & 1) \
                            + 8 * ald * (j >> 1)
                        lo, hi = ap[q], ap[q + ald]
                    else:
                        q = (r0 + g) * ald + 2 * t + 8 * ald * (j & 1) \
                            + 8 * (j >> 1)
                        lo, hi = ap[q], ap[q + 1]
                    regs.append((bf16_round(lo), bf16_round(hi))
                                if ta == "f32"
                                else _i8_pair(u8(lo) | u8(hi) << 8))
                af.append(regs)
        # B fragments, [lane][n-tile] = (b0, b1), each (lo, hi)
        bfr = [[None] * (tile // 8) for _ in range(32)]
        if tb == "bf16":
            for np_ in range(tile // 16):
                addrs = [((lane & 7) + 8 * ((lane >> 3) & 1)) * bld
                         + 16 * np_ + 8 * ((lane >> 3) >> 1)
                         for lane in range(32)]
                r = _ldmatrix(bp, addrs, True)
                for lane in range(32):
                    bfr[lane][2 * np_] = (r[lane][0], r[lane][1])
                    bfr[lane][2 * np_ + 1] = (r[lane][2], r[lane][3])
        else:
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for q in range(tile // 32):
                    p = 2 * t * bld + 32 * q + 4 * g
                    w = [sum(u8(bp[p + d * bld + i]) << 8 * i
                             for i in range(4)) ^ 0x80808080
                         for d in (0, 1, 8, 9)]
                    for j in range(4):
                        bfr[lane][4 * q + j] = (
                            _hi_pair(_i8_f32(w[0], 0x7440 | j),
                                     _i8_f32(w[1], 0x7440 | j)),
                            _hi_pair(_i8_f32(w[2], 0x7440 | j),
                                     _i8_f32(w[3], 0x7440 | j)))
        # the mma: A 16 x 16 and each n-tile's B 16 x 8 from the layout
        A16 = np.full((16, 16), np.nan)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j, (row, k) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                          (g, 2 * t + 8), (g + 8, 2 * t + 8))):
                A16[row, k:k + 2] = af[lane][j]
        for nt in range(tile // 8):
            B8 = np.full((16, 8), np.nan)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                B8[2 * t:2 * t + 2, g] = bfr[lane][nt][0]
                B8[2 * t + 8:2 * t + 10, g] = bfr[lane][nt][1]
            C = A16 @ B8
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(4):
                    row = r0 + g + 8 * (e >> 1)
                    col = (32 * (nt // 4) + 4 * (2 * t + (e & 1)) + nt % 4
                           if tb == "int8" else 8 * nt + 2 * t + (e & 1))
                    assert np.isnan(out[row, col])
                    out[row, col] = C[g + 8 * (e >> 1), 2 * t + (e & 1)]
    np.testing.assert_array_equal(out, Av @ Bv)
