"""The port's stage runner (``s2p_tpu_torch/runner.py``) and the deadline
of its stage drivers.

Every case of ``tests/test_runner.py`` runs against both runners, the
JAX package's and the port's copy.  Then each of the port's stage drivers
that fans tiles out (``rectification_all``, ``disparity_to_ply_all``,
``pointing_correction_all``) is given one per-tile call that hangs on an
``Event``: with ``timeout=1`` the driver must raise the port's
``TimeoutError_`` within 15 s (the call's deadline, then the runner's
10 s grace join), not wait for the hung call.  The event is set at
teardown, so no thread outlives the test.
"""

import threading
import time

import numpy as np
import pytest

from s2p_tpu import runner as jrunner
from s2p_tpu_torch import pipeline as tpipe
from s2p_tpu_torch import runner as trunner
from s2p_tpu_torch.config import Config, ImageSpec

HANG_BOUND_S = 15.0


@pytest.fixture(params=['s2p_tpu', 's2p_tpu_torch'])
def runner(request):
    return jrunner if request.param == 's2p_tpu' else trunner


def test_exceptions_propagate(runner):
    def boom(x):
        raise ValueError(f'bad tile {x}')

    with pytest.raises(ValueError, match='bad tile'):
        runner.launch_calls(boom, [1, 2, 3], 2, tilewise=False, timeout=10)


def test_timeout_raises(runner):
    def slow(x):
        time.sleep(5)
        return x

    with pytest.raises(runner.TimeoutError_):
        runner.launch_calls(slow, [1, 2], 2, tilewise=False, timeout=1)


def test_results_in_order(runner):
    def work(x):
        time.sleep(0.01 * (5 - x))
        return x * 10

    out = runner.launch_calls(work, [1, 2, 3, 4], 4, tilewise=False,
                              timeout=10)
    assert out == [10, 20, 30, 40]


def test_extra_args_and_tuple_items(runner):
    def f(a, b, c):
        return a + b + c

    out = runner.launch_calls(f, [(1, 2), (3, 4)], 2, 10, tilewise=False,
                              timeout=10)
    assert out == [13, 17]


def test_tile_logs_isolated_per_thread(runner, tmp_path):
    tiles = []
    for k in range(6):
        d = tmp_path / f'tile_{k}'
        d.mkdir()
        tiles.append({'dir': str(d)})

    def work(tile):
        print(f"hello from {tile['dir']}")
        time.sleep(0.01)
        return tile['dir']

    out = runner.launch_calls(work, tiles, 3, timeout=30)
    assert out == [t['dir'] for t in tiles]
    for t in tiles:
        log = (tmp_path / t['dir'] / 'stdout.log').read_text()
        assert log == f"hello from {t['dir']}\n"


def test_worker_exception_logged_in_tile_log(runner, tmp_path):
    d = tmp_path / 'tile_x'
    d.mkdir()

    def boom(tile):
        raise RuntimeError('tile exploded')

    with pytest.raises(RuntimeError, match='tile exploded'):
        runner.launch_calls(boom, [{'dir': str(d)}], 1, timeout=30)
    assert 'tile exploded' in (d / 'stdout.log').read_text()


def test_timeout_is_per_call_not_cumulative(runner):
    def work(x):
        time.sleep(0.3)
        return x

    t0 = time.monotonic()
    out = runner.launch_calls(work, list(range(6)), 2, tilewise=False,
                              timeout=1.0)
    assert out == list(range(6))
    assert time.monotonic() - t0 < 5


def test_hung_tile_raises_quickly_and_cancels_siblings(runner):
    started = []

    def hang(x):
        started.append(x)
        for _ in range(200):
            time.sleep(0.05)
            if runner.cancelled():
                return 'cancelled'
        return 'finished'

    t0 = time.monotonic()
    with pytest.raises(runner.TimeoutError_):
        runner.launch_calls(hang, [1, 2], 2, tilewise=False, timeout=0.4)
    assert time.monotonic() - t0 < 3
    assert not runner.cancelled()


def test_checkpoint_raises_when_cancelled(runner):
    class _Ev:
        def is_set(self):
            return True

    runner._cancel_stack.append(_Ev())
    try:
        with pytest.raises(runner.TimeoutError_):
            runner.checkpoint()
    finally:
        runner._cancel_stack.pop()


def test_warmup_first_excludes_compile_time(runner):
    slow_once = {'done': False}

    def fn(i):
        if not slow_once['done']:
            slow_once['done'] = True
            time.sleep(1.2)
        return i * 2

    r = runner.launch_calls(fn, list(range(5)), 2, timeout=0.8,
                            tilewise=False, warmup_first=True)
    assert r == [0, 2, 4, 6, 8]


def test_timeout_leaves_interpreter_usable(runner):
    def hang(i):
        if i == 0:
            for _ in range(400):
                if runner.cancelled():
                    return i
                time.sleep(0.05)
        return i

    t0 = time.monotonic()
    with pytest.raises(runner.TimeoutError_):
        runner.launch_calls(hang, [0, 1], 2, timeout=0.3, tilewise=False)
    assert time.monotonic() - t0 < 4.0
    assert runner.launch_calls(lambda i: i + 1, [1, 2], 2, tilewise=False,
                               timeout=5) == [2, 3]


def test_pool_runner_maps_tuple_items():
    """PoolRunner.map calls fun(item), tuples included."""
    assert trunner.PoolRunner(2, timeout=5).map(len, [(1, 2), (3,)]) == [2, 1]


def test_serial_runner_maps_in_order(runner):
    """SerialRunner.map calls fun(item) for each item in turn on the
    caller's thread, tuples included, and lets an exception through."""
    calls = []

    def fun(item):
        calls.append((item, threading.get_ident()))
        return len(item) if isinstance(item, tuple) else item * 2

    items = [3, (1, 2), 5, (4,)]
    assert runner.SerialRunner().map(fun, items) == [6, 2, 10, 1]
    assert [c[0] for c in calls] == items
    assert {c[1] for c in calls} == {threading.get_ident()}
    assert runner.SerialRunner().map(fun, []) == []
    with pytest.raises(ZeroDivisionError):
        runner.SerialRunner().map(lambda x: 1 / x, [1, 0, 2])


# --------------------------------------------------------------------- #
# The stage drivers' deadline
# --------------------------------------------------------------------- #

@pytest.fixture
def hang():
    """A per-tile call that hangs on an event for the tile whose key is
    ``'hung'``; the event is set at teardown."""
    release = threading.Event()

    def call(key, result=None):
        if key == 'hung':
            release.wait(120)
        return result

    yield call
    release.set()


def _tiles(tmp_path, n=3):
    tiles = []
    for k in range(n):
        d = tmp_path / f'tile_{k}'
        (d / 'pair_1').mkdir(parents=True)
        tiles.append({'dir': str(d), 'coordinates': (8 * k, 0, 8, 8),
                      'neighborhood_dirs': [],
                      'key': 'hung' if k == 1 else 'ok'})
    return tiles


def _raises_in_time(fn):
    t0 = time.monotonic()
    with pytest.raises(trunner.TimeoutError_):
        fn()
    elapsed = time.monotonic() - t0
    assert elapsed < HANG_BOUND_S, elapsed


def test_rectification_all_bounds_a_hung_tile(tmp_path, monkeypatch, hang):
    tiles = _tiles(tmp_path)
    monkeypatch.setattr(tpipe, '_rectification_geometry',
                        lambda cfg, tile, i: hang(tile['key']))
    _raises_in_time(lambda: tpipe.rectification_all(
        Config(), [(t, 1) for t in tiles], timeout=1, device='cpu'))


def test_disparity_to_ply_all_bounds_a_hung_tile(tmp_path, monkeypatch,
                                                 hang):
    tiles = _tiles(tmp_path)
    cfg = Config(images=(ImageSpec(img='ref.tif'), ImageSpec(img='sec.tif')),
                 out_crs='epsg:32740')
    monkeypatch.setattr(tpipe, '_ply_tile_job', lambda cfg, tile: {})
    monkeypatch.setattr(tpipe.triangulation, 'disp_to_xyz_batch',
                        lambda jobs, out_crs, device: [
                            (np.zeros((2, 2, 3), np.float32), None)
                            for _ in jobs])
    monkeypatch.setattr(tpipe, '_ply_tile_finish',
                        lambda cfg, tile, job, xyz, count, colors:
                        hang(tile['key']))
    _raises_in_time(lambda: tpipe.disparity_to_ply_all(
        cfg, tiles, timeout=1, device='cpu'))


def test_pointing_correction_all_bounds_a_hung_tile(tmp_path, monkeypatch,
                                                    hang):
    tiles = _tiles(tmp_path)
    cfg = Config(images=(ImageSpec(img='ref.tif'), ImageSpec(img='sec.tif')))
    m = np.ones((12, 4), np.float32)
    monkeypatch.setattr(tpipe, '_image', lambda path: np.zeros((8, 8)))
    monkeypatch.setattr(tpipe.sift_ops, 'matches_on_rpc_roi_batch',
                        lambda jobs, device: [m for _ in jobs])
    monkeypatch.setattr(
        tpipe.pointing, 'local_translation',
        lambda r1, r2, x, y, w, h, matches, n, **kw:
        hang('hung' if x == 8 else 'ok', np.eye(3)))
    _raises_in_time(lambda: tpipe.pointing_correction_all(
        cfg, [(t, 1) for t in tiles], timeout=1, device='cpu'))
