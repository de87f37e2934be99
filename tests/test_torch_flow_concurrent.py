"""The flow's two-sided scan entry (``sgm_kernels.flow_partials_sides``, the
scans of both sides and both orientations at once on the card) on
device="cpu", against the pass-by-pass route of one side at a time, the
JAX package's ``flow_partials_from_sigs`` in interpret mode and the batch
entry; and the scan's wrappers past 4096 candidates against the JAX
package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s2p_tpu.ops import mgm_flow as mf
from s2p_tpu.ops import sgm_pallas as sp
from s2p_tpu_torch.ops import mgm_flow as tf
from s2p_tpu_torch.ops import sgm_kernels as sk


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == 'f' \
        else a == b
    assert same.all(), f'{(~same).sum()} of {same.size} entries differ'


def _bucket(D, n=2, Hp=40, Wp=64, seed=11):
    """n tiles of Hp x Wp from a numpy seed: a smoothed texture and the
    reference shifted by a known disparity, NaN borders, different true
    extents and ranges inside the D candidates."""
    rng = np.random.RandomState(seed)
    b1 = np.full((n, Hp, Wp), np.nan, np.float32)
    b2 = np.full((n, Hp, Wp), np.nan, np.float32)
    hs, w1s, w2s, dmins, dts = [], [], [], [], []
    for k in range(n):
        h, w = Hp - 3 * k - 1, Wp - 5 * k - 2
        tex = rng.rand(h, w).astype(np.float32) * 200
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3
        xs = np.arange(w, dtype=np.float32)
        ref = np.stack([np.interp(xs + 2.5 + k, xs, r) for r in tex])
        ref[:3] = np.nan
        sec = tex[:, :w - 2 * k].copy()
        sec[:, -4:] = np.nan
        b1[k, :h, :w] = ref
        b2[k, :h, :sec.shape[1]] = sec
        hs.append(h)
        w1s.append(w)
        w2s.append(sec.shape[1])
        dts.append(D - k)
        dmins.append(-(D // 3) + k)
    return b1, b2, hs, w1s, w2s, dmins, dts


def _sides(b1, b2, hs, w1s, w2s, dmins, dts, D, v):
    """The kernel inputs of both sides as the batched flow builds them:
    [(sr, ss, base, pad, emit_votes)] and the allowed mask."""
    ints = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    s1 = tf.census_bits_raw(torch.from_numpy(b1), v.census_win)[..., 0]
    s2 = tf.census_bits_raw(torch.from_numpy(b2), v.census_win)[..., 0]
    dm, dt = ints(dmins), ints(dts)
    h, w1, w2 = ints(hs), ints(w1s), ints(w2s)
    allowed = (torch.arange(D)[None, :] < dt[:, None]).to(torch.int32)
    out = []
    for sr, ss, base, wr, ws, votes in ((s1, s2, dm, w1, w2, True),
                                         (s2, s1, -(dm + dt - 1), w2, w1,
                                          False)):
        r, s, pad = tf._side_sigs(sr, ss, base, h, wr, ws, extra=D)
        out.append((r, s, base, pad, votes))
    return out, allowed


def _pass_by_pass(sr, ss, D, v, allowed, emit_votes):
    """One side's partials with the scans one after another in the flow's
    launch order (hf, hb, vf, vb), as the port ran them before its scans
    ran concurrently."""
    nbits = v.census_win ** 2 - 1
    B, H, W = sr.shape
    s1t = sr.transpose(1, 2).contiguous()
    s2t, pad, sec_len = sk.prepass_secondary(ss, W, 0, D)
    cost_h = sk.cost_prepass(s1t, s2t, D, 0, nbits, pad, sec_len, allowed)
    cost = {'v': cost_h.permute(0, 3, 2, 1).contiguous(), 'h': cost_h}
    p2 = {'v': torch.full((B, H, W), v.p2), 'h': torch.full((B, W, H), v.p2)}
    S = {'v': None, 'h': None}
    passes = sk.scan_passes(v)
    votes = [None] * sum(len(i) for _, i, _ in passes)
    sub = float(len(votes) - 1) if v.overcount_fix else 0.0
    for key, idx, lats in passes:
        o = key[0]
        S[o], vo = sk.scan(cost[o], p2[o], lats, v.p1, tf.BIG,
                           reverse=key[1] == 'b', sub_cost_mult=sub,
                           accum=S[o], emit_votes=emit_votes)
        sub = 0.0
        for j, i in enumerate(idx if vo is not None else ()):
            votes[i] = vo[:, j] if o == 'v' else vo[:, j].transpose(1, 2)
    return [S['v'], S['h'].permute(0, 3, 2, 1)], votes


@pytest.mark.parametrize('D', [16, 17])
def test_two_sided_scans_match_pass_by_pass_jax_and_batch(D):
    v = tf.MgmVariant()
    data = _bucket(D)
    sides, allowed = _sides(*data, D, v)
    got = sk.flow_partials_sides([(sr, ss, 0, ev) for sr, ss, _, _, ev
                                  in sides], D, v, allowed=allowed)
    maps = []
    for (parts, votes), (sr, ss, base, pad, ev) in zip(got, sides):
        ref_parts, ref_votes = _pass_by_pass(sr, ss, D, v, allowed, ev)
        assert len(parts) == len(ref_parts) == 2
        for p, r in zip(parts, ref_parts):
            _same(p.numpy(), r.numpy())
        assert [vo is None for vo in votes] == [not ev] * len(votes)
        for vo, r in zip(votes, ref_votes):
            if ev:
                _same(vo.numpy(), r.numpy())
        # the JAX package's one-side entry, tile by tile
        for b in range(sr.shape[0]):
            jp, jv = sp.flow_partials_from_sigs(
                jnp.asarray(sr[b].numpy().view(np.uint32)),
                jnp.asarray(ss[b].numpy().view(np.uint32)), 0, D,
                mf.MgmVariant(backend='interpret'),
                allowed=jnp.asarray(allowed[b].numpy()), interpret=True,
                emit_votes=ev)
            for p, r in zip(parts, jp):
                _same(p[b].numpy(), r)
            for vo, r in zip(votes if ev else (), jv):
                _same(vo[b].numpy(), r)
        # offsets and disparities of both routes
        off, d_int = sk.wta(parts, v.subpix, tf.BIG / 2)
        off_r, d_r = sk.wta(ref_parts, v.subpix, tf.BIG / 2)
        _same(off.numpy(), off_r.numpy())
        _same(d_int.numpy(), d_r.numpy())
        disp = (base.to(torch.float32)[:, None, None]
                + d_int.to(torch.float32)) + off
        maps.append((torch.where(pad, float('nan'), disp), d_int, votes))
    # the batch entry runs the two-sided entry; the pass-by-pass maps
    # through the same post chain give its outputs bitwise
    b1, b2, hs, w1s, w2s, dmins, dts = data
    (dL, d_int, votes), (dR, _, _) = maps
    ints = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    disp, conf = tf._flow_post(dL, dR, d_int, votes, v, ints(w2s),
                               k_lo=ints(dmins) - 1, k_cnt=D + 2)
    out = tf.mgm_binary_match_batch(b1, b2, dmins, D, hs, w1s, w2s, dts, v,
                                    device='cpu')
    _same(out['disp'].numpy(), disp.numpy())
    _same(out['confidence'].numpy(), conf.numpy())
    assert np.isfinite(out['disp'].numpy()).mean() > 0.4


def test_one_side_entry_is_the_two_sided_entry_of_one_side():
    v = tf.MgmVariant(nb_dir=4)
    D = 16
    sides, allowed = _sides(*_bucket(D, n=1), D, v)
    sr, ss, _, _, _ = sides[0]
    one = sk.flow_partials_from_sigs(sr, ss, D, v, allowed=allowed)
    two = sk.flow_partials_sides([(sr, ss, 0, True)], D, v, allowed)[0]
    for a, b in zip(one[0] + one[1], two[0] + two[1]):
        _same(a.numpy(), b.numpy())


@pytest.mark.parametrize('nb_dir', [2, 4, 5, 8])
def test_flow_chains_cover_every_pass_once(nb_dir):
    v = tf.MgmVariant(nb_dir=nb_dir)
    passes = sk.scan_passes(v)
    chains = sk.flow_chains(v)
    flat = [c for chain in chains.values() for c in chain]
    assert sorted(c[0] for c in flat) == sorted(p[0] for p in passes)
    for o, chain in chains.items():
        # launch order inside an orientation, as scan_passes has it
        assert [c[0] for c in chain] == [p[0] for p in passes
                                         if p[0][0] == o]
        assert all(c[0][0] == o for c in chain)
    n_dirs = sum(len(p[1]) for p in passes)
    subs = {c[0]: c[3] for c in flat}
    assert subs[passes[0][0]] == float(n_dirs - 1)
    assert sum(1 for s in subs.values() if s) == 1
    assert sorted(i for c in flat for i in c[1]) == list(range(n_dirs))


def _h_pad(dmin, D, G=8):
    """The horizontal secondary's padding of ``sgm_pallas``."""
    pad = max(0, -dmin, dmin + D)
    return pad + (-(dmin + pad)) % G


def _sigs(rng, shape):
    s = rng.randint(0, 1 << 24, size=shape).astype(np.uint32)
    s |= (rng.rand(*shape) < 0.9).astype(np.uint32) << sp._VALID_BIT
    s |= (rng.rand(*shape) < 0.1).astype(np.uint32) << sp._PAD_BIT
    return s


def _t(a):
    """uint32 or other numpy -> torch with a batch axis of 1."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a)[None]


# past 4096 candidates the card runs the scan's wide kernel; the wrappers
# take up to 16384 on both devices.  (orientation, reverse, laterals,
# overcount multiplier, accum)
_WIDE_CASES = {
    'cost_v_sub': ('cost', False, ((0,), (1,), (-1,)), 2.0, False),
    'cost_h_accum': ('cost', True, ((0,),), 0.0, True),
    'sig_v_allowed': ('sig_v', True, ((0,), (-1,), (1,)), 2.0, True),
    'sig_h': ('sig_h', False, ((0,),), 0.0, False),
}


@pytest.mark.parametrize('case', sorted(_WIDE_CASES))
def test_scan_past_4096_candidates_matches_pallas(case):
    mode, reverse, dirs, sub, with_accum = _WIDE_CASES[case]
    rng = np.random.RandomState(len(case))
    N, W, D, dmin = 8, 5, 4097, -2050
    p2 = rng.choice([16.0, 32.0], size=(N, W)).astype(np.float32)
    accum = (rng.randint(0, 3000, size=(N, D, W)).astype(np.float32)
             if with_accum else None)
    kw = dict(sub_cost_mult=sub)
    if mode == 'cost':
        cost = rng.randint(0, 25, size=(N, D, W)).astype(np.uint8)
        cost[rng.rand(N, D, W) < 0.2] = 255
        S_ref, v_ref = sp._scan_pass_pallas(
            None, None, jnp.asarray(p2), D, 0, list(dirs), 8.0, tf.BIG, 24,
            reverse, False, interpret=True, emit_votes=True,
            accum=None if accum is None else jnp.asarray(accum),
            cost=jnp.asarray(cost), **kw)
        S, v = sk.scan(_t(cost), _t(p2), [l[0] for l in dirs], 8.0, tf.BIG,
                       reverse, accum=None if accum is None else _t(accum),
                       **kw)
    else:
        horizontal = mode == 'sig_h'
        s1 = _sigs(rng, (N, W))
        pad = _h_pad(dmin, D) if horizontal else 0
        s2 = np.pad(_sigs(rng, (N, W)), ((pad, pad), (0, 0)))
        allowed = (rng.rand(D) < 0.8).astype(np.int32)
        S_ref, v_ref = sp._scan_pass_pallas(
            jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(p2), D, dmin,
            list(dirs), 8.0, 24.0, 24, reverse, horizontal, interpret=True,
            allowed=jnp.asarray(allowed)[:, None],
            accum=None if accum is None else jnp.asarray(accum), **kw)
        S, v = sk.scan_sig(
            _t(s1), _t(s2), _t(p2), dirs, 8.0, 24.0, 24, D, dmin,
            N if horizontal else W, reverse, horizontal, pad=pad,
            allowed=_t(allowed), accum=None if accum is None else _t(accum),
            **kw)
    _same(S[0].numpy(), S_ref)
    _same(v[0].numpy(), v_ref)
    assert (np.asarray(S_ref) < 24.0 * len(dirs)).any()
