"""The attention kernels' C entry points against their Python callers.

``ops/attention.py`` declares each entry point's ctypes argument types from
the ``extern "C"`` block of ``csrc/attention.cu`` (``_build.bind``).  A
call that passes another number of arguments, or a value of another kind,
shows only on the card, as a wrong argument or a crash: ctypes passes extra
arguments on unchecked.  So these tests bind a stand-in library from the C
source, call every entry point through the wrapper code on CPU tensors,
and convert each argument as ctypes would."""

import ctypes

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
