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

    def __init__(self, name, kernels):
        self.name, self.kernels, self.calls = name, kernels, []

    def __call__(self, *args):
        assert len(args) == len(self.argtypes), (self.name, len(args), len(self.argtypes))
        for i, (kind, arg) in enumerate(zip(self.argtypes, args)):
            try:
                kind.from_param(arg)
            except TypeError as e:
                raise AssertionError(f"{self.name}: argument {i} {arg!r} is not a {kind}") from e
        if self.name.endswith("_dq"):   # the kernels-launched out-parameter
            args[-2]._obj.value = self.kernels
        self.calls.append(args)
        return 0


class _Library:
    def __init__(self, kernels=1):
        for name in _declared_in_c():
            setattr(self, name, _Entry(name, kernels))


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
    "edl_attn_bwd_delta": lambda lib, q, k, v, o, do, lse, dl: tattn._run_delta(o, do, lib=lib),
    "edl_attn_bwd_dkdv": lambda lib, q, k, v, o, do, lse, dl: tattn._run_dkdv(
        "edl_attn_bwd_dkdv", q, k, v, do, lse, dl, SCALE, None, lib=lib),
    "edl_flash_bwd_dkdv": lambda lib, q, k, v, o, do, lse, dl: tattn._run_dkdv(
        "edl_flash_bwd_dkdv", q, k, v, do, lse, dl, SCALE, False, lib=lib),
    "edl_attn_bwd_dq": lambda lib, q, k, v, o, do, lse, dl: tattn._run_dq(
        "edl_attn_bwd_dq", q, k, v, o, do, lse, SCALE, None, lib=lib),
    "edl_flash_bwd_dq": lambda lib, q, k, v, o, do, lse, dl: tattn._run_dq(
        "edl_flash_bwd_dq", q, k, v, o, do, lse, SCALE, True, lib=lib),
}


def test_every_entry_point_is_declared_once_in_c():
    assert sorted(_declared_in_c()) == sorted(CALLS)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_wrapper_call_matches_the_c_source(lib, name):
    CALLS[name](lib, *_inputs())
    (args,) = getattr(lib, name).calls
    assert len(args) == len(_declared_in_c()[name])


@pytest.mark.parametrize("path", ["splash", "flash"])
def test_dq_wrapper_counts_the_standalone_delta_the_entry_point_ran(monkeypatch, path):
    """Above D = 256 a dQ entry point runs the standalone delta, then the
    wide dQ, and reports two kernels: the dQ wrapper then counts one launch
    of each; at one kernel, dQ's alone."""
    monkeypatch.setattr(tattn, "_stream", lambda t: tattn._P(0))
    monkeypatch.setattr(tattn, "_on_cpu", lambda *ts: False)
    q, k, v, o, do, lse, _ = _inputs()
    wrapper = tattn.attention_bwd_dq if path == "splash" else tattn.flash_bwd_dq
    extra = () if path == "splash" else (True,)
    tattn.reset_launch_counts()
    for kernels in (1, 2):
        lib = _build.bind(_Library(kernels), (_build.CSRC / "attention.cu").read_text())
        monkeypatch.setattr(tattn, "_kernels", lambda lib=lib: lib)
        dq, delta = wrapper(q, k, v, o, do, lse, SCALE, *extra)
        assert dq.shape == q.shape and delta.shape == (B, H, L)
    counts = tattn.launch_counts()
    tattn.reset_launch_counts()
    assert counts[wrapper.__name__] == 2 and counts["attention_bwd_delta"] == 1
    assert sum(counts.values()) == 3


def test_dq_entry_points_take_o_and_return_delta():
    """The dQ entry points read o and write delta (a non-const pointer)
    before dq, and report the kernels they launched through an ``int*``
    before the stream; the flash one takes the flash sizes."""
    src = (_build.CSRC / "attention.cu").read_text()
    for name in ("edl_attn_bwd_dq", "edl_flash_bwd_dq"):
        head = src[src.index(f"int {name}("):]
        params = [" ".join(p.split()) for p in head[head.index("(") + 1:head.index(")")].split(",")]
        names = [p.split()[-1].lstrip("*") for p in params]
        assert names[:8] == ["q", "k", "v", "o", "dout", "lse", "dlt", "dqp"], names
        assert params[6].startswith("void*") and params[5].startswith("const"), params
        assert params[-2] == "int* kernels" and names[-1] == "stream", params


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
    "dq_wide": lambda d: "attn_bwd_dq_wide_kernel",
    "dkdv_sm90": lambda d: "attn_dkdv_sm90_kernel" if d <= 128 else "attn_dkdv_split_sm90_kernel",
    "dkdv_chunk_sm90": lambda d: "attn_dkdv_chunk_sm90_kernel",
    "dkdv_wide": lambda d: "attn_bwd_dkdv_wide_kernel",
}


def test_routers_branch_at_256_and_512():
    """The forward runs attention_sm90.cu up to D = 256, the Hopper kernel
    whose consumers split the output columns up to 512 and, above, the
    Hopper kernel that does the same on chunks of the columns (no mma.sync
    forward is left); dK/dV runs attention_sm90.cu up to 512 (above 256 the
    kernel whose blocks split the output columns) and the mma.sync one
    above; dQ (the standalone delta first above 256) changes kernels at
    256; each launcher instantiates the head dims its branch passes it, and
    the forward above 512 takes D at run time."""
    assert _router("fwd")[:2] == ([(256, "fwd_sm90"), (512, "fwd_split_sm90")], "fwd_chunk_sm90")
    assert _router("dkdv")[:2] == ([(256, "dkdv_sm90"), (512, "dkdv_chunk_sm90")], "dkdv_wide")
    branches, rest, body = _router("dq")
    assert (branches, rest) == ([(256, "dq_sm90")], "dq_wide")
    assert body.index("delta(D, o, dout") < body.rindex("return dq_wide(")

    def cases(source, macro):
        text = (_build.CSRC / source).read_text()
        return {int(d) for d in re.findall(rf"^\s*{macro}\((\d+)\)\s*$", text, re.M)}

    assert cases("attention_sm90.cu", "EDL_FWD") == {64, 128, 192, 256}
    assert cases("attention_wide_sm90.cu", "EDL_FWD_SPLIT") == {320, 384, 448, 512}
    assert cases("attention_sm90.cu", "EDL_DKDV_CHUNK") == {320, 384, 448, 512}
    chunk_sm90 = (_build.CSRC / "attention_chunk_sm90.cu").read_text()
    assert cases("attention_chunk_sm90.cu", "EDL_FWD_CHUNK") == {576, 640, 704, 768}
    assert "if (D <= 768 || D % 64 != 0) return cudaErrorInvalidValue;" in chunk_sm90
    assert "attn_fwd_wide_kernel" not in (_build.CSRC / "attention_wide.cu").read_text()
    assert "if constexpr (D <= 128)" in (_build.CSRC / "attention_sm90.cu").read_text()


@pytest.mark.parametrize("d", range(64, 1025, 64))
def test_device_kernels_follow_the_routers(d):
    """``device_kernels(d)``, which the card's profile checks read, names
    the kernels the C routers launch at head dim d, in launch order."""
    fwd = LAUNCHED[_routed("fwd", d)](d)
    dq = LAUNCHED[_routed("dq", d)](d)
    dkdv = LAUNCHED[_routed("dkdv", d)](d)
    delta = ("attn_bwd_delta_kernel",) if d > 256 else ()
    assert tattn.device_kernels(d) == (fwd, *delta, dq, dkdv)
