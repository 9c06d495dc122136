"""``ops/fused.exact_f32_matmul`` across threads: the two settings it
pins (``torch.get_float32_matmul_precision()`` and
``torch.backends.cudnn.allow_tf32``) are process-global, so a block must
stay exact while a block of another thread opens and closes around it,
and the caller's own settings must come back once the last block closes.

Each case starts from a caller who allowed TF32 (``"high"``, cuDNN TF32
on) and is restored afterwards. The threads are ordered with
``threading.Event``s, never with sleeps."""

import sys
import threading

import pytest
import torch

from vali_tpu_torch.ops.fused import exact_f32_matmul

EXACT = ("highest", False)
USER = ("high", True)
TIMEOUT = 30.0


def _flags():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def user_allows_tf32():
    saved = _flags()
    torch.set_float32_matmul_precision(USER[0])
    torch.backends.cudnn.allow_tf32 = USER[1]
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def _start(fn):
    """Run ``fn`` on a thread; the thread and the list its exception (if
    any) lands in."""
    errors = []

    def run():
        try:
            fn()
        except BaseException as e:  # reported by _join in the main thread
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    return t, errors


def _join(t, errors):
    t.join(TIMEOUT)
    assert not t.is_alive()
    if errors:
        raise errors[0]


def test_a_block_stays_exact_when_another_thread_leaves(user_allows_tf32):
    """A enters, B enters, A exits, then B reads the flags: still exact.
    After B exits, the caller's settings are back."""
    a_in, b_in, a_out, b_read = (threading.Event() for _ in range(4))
    seen = {}

    def thread_a():
        with exact_f32_matmul():
            seen["a"] = _flags()
            a_in.set()
            assert b_in.wait(TIMEOUT)
        a_out.set()

    def thread_b():
        assert a_in.wait(TIMEOUT)
        with exact_f32_matmul():
            b_in.set()
            assert a_out.wait(TIMEOUT)
            seen["b_after_a"] = _flags()
            b_read.set()

    ta, tb = _start(thread_a), _start(thread_b)
    _join(*ta)
    _join(*tb)
    assert b_read.is_set()
    assert seen == {"a": EXACT, "b_after_a": EXACT}
    assert _flags() == USER


def test_a_change_made_while_a_block_is_open_is_undone(user_allows_tf32):
    """The caller changes both settings from another thread while A's
    block is open; when A's block, the last one, closes, the values saved
    before it opened come back and the change is gone."""
    a_in, changed = threading.Event(), threading.Event()
    seen = {}

    def thread_a():
        with exact_f32_matmul():
            a_in.set()
            assert changed.wait(TIMEOUT)
            seen["a_after_change"] = _flags()

    ta = _start(thread_a)
    assert a_in.wait(TIMEOUT)
    torch.set_float32_matmul_precision("medium")
    torch.backends.cudnn.allow_tf32 = False
    changed.set()
    _join(*ta)
    assert seen == {"a_after_change": ("medium", False)}
    assert _flags() == USER


def test_nested_blocks_in_one_thread(user_allows_tf32):
    with exact_f32_matmul():
        with exact_f32_matmul():
            assert _flags() == EXACT
        assert _flags() == EXACT
    assert _flags() == USER


def test_an_exception_inside_a_block_restores_the_settings(
        user_allows_tf32):
    with pytest.raises(ValueError, match="inside"):
        with exact_f32_matmul():
            assert _flags() == EXACT
            raise ValueError("raised inside the block")
    assert _flags() == USER
    with exact_f32_matmul():   # the count went back to 0: a new block
        assert _flags() == EXACT   # saves and sets again
    assert _flags() == USER


def test_many_threads_never_see_tf32_inside_a_block(user_allows_tf32):
    """Stress: more threads than cores enter and leave blocks with a short
    switch interval; every read inside a block is exact, and the caller's
    settings are back at the end."""
    bad = []
    go = threading.Event()

    def worker():
        assert go.wait(TIMEOUT)
        for _ in range(200):
            with exact_f32_matmul():
                if _flags() != EXACT:
                    bad.append(_flags())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [_start(worker) for _ in range(16)]
        go.set()
        for t in threads:
            _join(*t)
    finally:
        sys.setswitchinterval(interval)
    assert bad == []
    assert _flags() == USER
