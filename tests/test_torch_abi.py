"""The attention kernels' C entry points against their Python callers.

``ops/attention.py`` declares each entry point's ctypes argument types from
the ``extern "C"`` block of ``csrc/attention.cu`` (``_build.bind``).  A
call that passes another number of arguments, or a value of another kind,
shows only on the card, as a wrong argument or a crash: ctypes passes extra
arguments on unchecked.  So these tests bind a stand-in library from the C
source, call every entry point through the wrapper code on CPU tensors,
and convert each argument as ctypes would."""

import ctypes
import re

import numpy as np
import pytest
import torch

from edl_tpu_torch.ops import _build
from edl_tpu_torch.ops import attention as tattn

B, L, H, D = 1, 8, 2, 64
SCALE = 0.125


def _declared_in_c():
    return _build.entry_points((_build.CSRC / "attention.cu").read_text())


class _Entry:
    """A stand-in entry point: checks the arity against its argtypes,
    converts every argument as ctypes does, and records the call."""

    def __init__(self, name):
        self.name, self.calls = name, []

    def __call__(self, *args):
        assert len(args) == len(self.argtypes), (self.name, len(args), len(self.argtypes))
        for i, (kind, arg) in enumerate(zip(self.argtypes, args)):
            try:
                kind.from_param(arg)
            except TypeError as e:
                raise AssertionError(f"{self.name}: argument {i} {arg!r} is not a {kind}") from e
        self.calls.append(args)
        return 0


class _Library:
    def __init__(self):
        for name in _declared_in_c():
            setattr(self, name, _Entry(name))


@pytest.fixture
def lib(monkeypatch):
    monkeypatch.setattr(tattn, "_stream", lambda t: tattn._P(0))
    return _build.bind(_Library(), (_build.CSRC / "attention.cu").read_text())


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, o, do = (torch.from_numpy(rng.standard_normal((B, L, H, D), np.float32))
                      .to(torch.bfloat16) for _ in range(5))
    lse, delta = (torch.from_numpy(rng.standard_normal((B, H, L), np.float32)) for _ in range(2))
    return q, k, v, o, do, lse, delta


# entry point -> its call through the wrappers' argument set-up
CALLS = {
    "edl_attn_fwd": lambda lib, q, k, v, o, do, lse, dl: tattn._run_fwd(
        "edl_attn_fwd", q, k, v, SCALE, None, lib=lib),
    "edl_flash_fwd": lambda lib, q, k, v, o, do, lse, dl: tattn._run_fwd(
        "edl_flash_fwd", q, k, v, SCALE, True, lib=lib),
    "edl_attn_bwd_dkdv": lambda lib, q, k, v, o, do, lse, dl: tattn._run_dkdv(
        "edl_attn_bwd_dkdv", q, k, v, do, lse, dl, SCALE, None, lib=lib),
    "edl_flash_bwd_dkdv": lambda lib, q, k, v, o, do, lse, dl: tattn._run_dkdv(
        "edl_flash_bwd_dkdv", q, k, v, do, lse, dl, SCALE, False, lib=lib),
    "edl_attn_bwd_dq": lambda lib, q, k, v, o, do, lse, dl: tattn._run_dq(
        "edl_attn_bwd_dq", q, k, v, o, do, lse, SCALE, None, lib=lib),
    "edl_flash_bwd_dq": lambda lib, q, k, v, o, do, lse, dl: tattn._run_dq(
        "edl_flash_bwd_dq", q, k, v, o, do, lse, SCALE, True, lib=lib),
    "edl_attn_bwd_smem": lambda lib, q, k, v, o, do, lse, dl: tattn.bwd_cluster_smem(4, True, lib=lib),
}


def test_every_entry_point_is_declared_once_in_c():
    assert sorted(_declared_in_c()) == sorted(CALLS)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_wrapper_call_matches_the_c_source(lib, name):
    CALLS[name](lib, *_inputs())
    (args,) = getattr(lib, name).calls
    assert len(args) == len(_declared_in_c()[name])


@pytest.mark.parametrize("path", ["splash", "flash"])
def test_dq_wrapper_counts_one_launch_per_call(monkeypatch, path):
    """A dQ entry point launches one kernel at every head dim, which writes
    delta too: the dQ wrapper counts one launch a call, and no other
    wrapper counts any."""
    monkeypatch.setattr(tattn, "_stream", lambda t: tattn._P(0))
    monkeypatch.setattr(tattn, "_on_cpu", lambda *ts: False)
    lib = _build.bind(_Library(), (_build.CSRC / "attention.cu").read_text())
    monkeypatch.setattr(tattn, "_kernels", lambda: lib)
    q, k, v, o, do, lse, _ = _inputs()
    wrapper = tattn.attention_bwd_dq if path == "splash" else tattn.flash_bwd_dq
    extra = () if path == "splash" else (True,)
    tattn.reset_launch_counts()
    for _ in range(2):
        dq, delta = wrapper(q, k, v, o, do, lse, SCALE, *extra)
        assert dq.shape == q.shape and delta.shape == (B, H, L)
    counts = tattn.launch_counts()
    tattn.reset_launch_counts()
    assert counts == {n: 2 if n == wrapper.__name__ else 0 for n in counts}
    assert len(getattr(lib, "edl_attn_bwd_dq" if path == "splash" else "edl_flash_bwd_dq").calls) == 2


def test_dq_entry_points_take_o_and_return_delta():
    """The dQ entry points read o and write delta (a non-const pointer)
    before dq, and take the scale, then the stream, last: one kernel
    launches at every head dim, so nothing reports a count of kernels."""
    src = (_build.CSRC / "attention.cu").read_text()
    for name in ("edl_attn_bwd_dq", "edl_flash_bwd_dq"):
        head = src[src.index(f"int {name}("):]
        params = [" ".join(p.split()) for p in head[head.index("(") + 1:head.index(")")].split(",")]
        names = [p.split()[-1].lstrip("*") for p in params]
        assert names[:8] == ["q", "k", "v", "o", "dout", "lse", "dlt", "dqp"], names
        assert params[6].startswith("void*") and params[5].startswith("const"), params
        assert params[-2] == "float scale" and names[-1] == "stream", params
        assert not any("kernels" in p for p in params), params


def test_parser_reads_kinds_and_refuses_unknown_types():
    src = 'extern "C" {\nint f(const void* a, int n,\n      float s, void* stream) {\n}\n}'
    assert _build.entry_points(src) == {"f": ["P", "I", "F", "P"]}
    with pytest.raises(ValueError, match="no ctypes kind"):
        _build.entry_points('extern "C" {\nint g(double x) {\n}\n}')


# -- routing by head dim ---------------------------------------------------------

def _router(fn):
    """A C router of ``attention.cu`` (``fwd``, ``dq``, ``dkdv``): its
    ``(bound, launcher)`` branches in order (``if (D <= bound) ... return
    launcher(``), the launcher past the last, and its body."""
    src = (_build.CSRC / "attention.cu").read_text()
    body = src[src.index(f"cudaError_t {fn}(int D"):]
    body = body[:body.index("\n}\n")]
    branches = [(int(b), name) for b, name in
                re.findall(r"if \(D <= (\d+)\)\s*\{?[^}]*?return (\w+)\(", body)]
    return branches, re.findall(r"return (\w+)\(", body)[-1], body


def _routed(fn, d):
    branches, rest, _ = _router(fn)
    return next((name for bound, name in branches if d <= bound), rest)


# the device kernel each launcher of the routers runs at head dim d
LAUNCHED = {
    "fwd_sm90": lambda d: "attn_fwd_sm90_kernel",
    "fwd_split_sm90": lambda d: "attn_fwd_split_sm90_kernel",
    "fwd_chunk_sm90": lambda d: "attn_fwd_chunk_sm90_kernel",
    "dq_sm90": lambda d: "attn_dq_sm90_kernel",
    "dq_cluster_sm90": lambda d: "attn_dq_cluster_sm90_kernel",
    "dq_wide": lambda d: "attn_bwd_dq_wide_kernel",
    "dkdv_sm90": lambda d: "attn_dkdv_sm90_kernel" if d <= 128 else "attn_dkdv_split_sm90_kernel",
    "dkdv_chunk_sm90": lambda d: "attn_dkdv_chunk_sm90_kernel",
    "dkdv_cluster_sm90": lambda d: "attn_dkdv_cluster_sm90_kernel",
    "dkdv_wide": lambda d: "attn_bwd_dkdv_wide_kernel",
}


def _cases(source, macro):
    text = (_build.CSRC / source).read_text()
    return {int(d) for d in re.findall(rf"^\s*{macro}\((\d+)\)\s*$", text, re.M)}


def test_routers_branch_at_256_and_512():
    """The forward runs attention_sm90.cu up to D = 256, the Hopper kernel
    whose consumers split the output columns up to 512 and, above, the
    Hopper kernel that does the same on chunks of the columns (no mma.sync
    forward is left); dK/dV runs attention_sm90.cu up to 384 (above 256 the
    kernel whose blocks split the output columns) and the cluster kernel
    up to 2048; dQ runs attention_sm90.cu up to 256 and the cluster kernel
    up to 2048, one kernel each, delta folded in (no standalone delta is
    left); past the largest cluster, D > 2048, the mma.sync dQ and dK/dV.
    Each launcher instantiates the head dims its branch passes it, and the
    forward above 512 takes D at run time."""
    assert _router("fwd")[:2] == ([(256, "fwd_sm90"), (512, "fwd_split_sm90")], "fwd_chunk_sm90")
    assert _router("dkdv")[:2] == ([(256, "dkdv_sm90"), (384, "dkdv_chunk_sm90"),
                                    (2048, "dkdv_cluster_sm90")], "dkdv_wide")
    branches, rest, body = _router("dq")
    assert (branches, rest) == ([(256, "dq_sm90"), (2048, "dq_cluster_sm90")], "dq_wide")
    entry = (_build.CSRC / "attention.cu").read_text()
    assert "delta(" not in body and "<<<" not in entry and "__global__" not in entry

    assert _cases("attention_sm90.cu", "EDL_FWD") == {64, 128, 192, 256}
    assert _cases("attention_wide_sm90.cu", "EDL_FWD_SPLIT") == {320, 384, 448, 512}
    assert _cases("attention_sm90.cu", "EDL_DKDV_CHUNK") == {320, 384}
    chunk_sm90 = (_build.CSRC / "attention_chunk_sm90.cu").read_text()
    assert _cases("attention_chunk_sm90.cu", "EDL_FWD_CHUNK") == {576, 640, 704, 768}
    assert "if (D <= 768 || D % 64 != 0) return cudaErrorInvalidValue;" in chunk_sm90
    assert "attn_fwd_wide_kernel" not in (_build.CSRC / "attention_wide.cu").read_text()
    assert "if constexpr (D <= 128)" in (_build.CSRC / "attention_sm90.cu").read_text()


def _cluster_plan(d):
    """The cluster of head dim d as attention_bwd_cluster_sm90.cu plans it:
    (blocks, 64-column boxes a block)."""
    nb = d // 64
    ranks = (nb + 3) // 4
    return ranks, -(-nb // ranks)


def test_cluster_kernels_instantiate_the_boxes_every_plan_needs():
    """The cluster kernels are instantiated for 3 and 4 boxes a block (W =
    192, 256), causal and not, and that is every plan from D = 320 to 2048:
    at most 8 blocks (the portable cluster size), their boxes covering D
    with less than one block's worth to spare."""
    src = (_build.CSRC / "attention_bwd_cluster_sm90.cu").read_text()
    assert _cases("attention_bwd_cluster_sm90.cu", "EDL_DKDV_CLUSTER") == {3, 4}
    assert _cases("attention_bwd_cluster_sm90.cu", "EDL_DQ_CLUSTER") == {3, 4}
    assert "constexpr int kMaxRanks = 8;" in src
    assert "const int nb = D / 64, ranks = (nb + 3) / 4;" in src
    for d in range(320, 2049, 64):
        ranks, bpr = _cluster_plan(d)
        assert bpr in (3, 4) and ranks <= 8 and 0 <= ranks * bpr - d // 64 < bpr, d
    assert _cluster_plan(2112)[0] == 9   # past the largest cluster: attention_wide.cu


@pytest.mark.parametrize("d", range(64, 2177, 64))
def test_device_kernels_follow_the_routers(d):
    """``device_kernels(d)``, which the card's profile checks read, names
    the kernels the C routers launch at head dim d, in launch order: one
    forward, one dQ (delta folded in) and one dK/dV kernel."""
    fwd = LAUNCHED[_routed("fwd", d)](d)
    dq = LAUNCHED[_routed("dq", d)](d)
    dkdv = LAUNCHED[_routed("dkdv", d)](d)
    assert tattn.device_kernels(d) == (fwd, dq, dkdv)
