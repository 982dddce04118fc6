"""The port's ``TrackingPose`` and ``PoseSimilarity`` against the JAX
package's, on painted frame sequences.

A painted sequence of 10 frames on a 31 x 31 cell grid (481 px): one
person moves every frame, one vanishes for one frame (fewer than
``forget_after`` = 2) and is recovered from the carried-over track, one
vanishes for four frames (more) and comes back under a new id, one new
person appears, and the sequence id changes for the last two frames, which
drops the track memory.  The TCAF field of each pair links every person
from where it was last seen to where it is now.  Both decoders run the
frames in order; per frame the track ids must be equal, and each id's
keypoints within 1e-4 in x, y and v.  ``batch_fields`` on an interleaved
batch of pairs, the decoder factory's precedence of ``TrackingPose`` over
``CifCaf``, and the ``eval_reset`` signal are checked as well.
"""

import argparse

import numpy as np
import pytest
import torch

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu.decoder import PoseSimilarity as JaxPoseSimilarity
from openpifpaf_tpu.decoder import TrackingPose as JaxTrackingPose
from openpifpaf_tpu.signal_ import Signal as JaxSignal
from openpifpaf_tpu_torch import decoder, headmeta
from openpifpaf_tpu_torch.datasets import LoaderWithReset
from openpifpaf_tpu_torch.decoder import CifCaf, PoseSimilarity, TrackingPose
from openpifpaf_tpu_torch.plugins.coco import constants

from test_decoder import build_fields, synthetic_pose
from test_tracking import paint_tcaf

SIDE = 31          # cells: 481 px
STRIDE = 16
TOL = 1e-4
FORGET_AFTER = 2
# (person, x offset in px) -> frames in which the person is present
SCHEDULE = {
    'moving': (-100.0, range(10)),
    'short_gap': (-20.0, [0, 1, 3, 4, 5, 6, 7, 8, 9]),
    'long_gap': (60.0, [0, 5, 6, 7, 8, 9]),
    'new': (140.0, [3, 4, 5, 6, 7, 8, 9]),
}
SEQUENCES = ['a'] * 8 + ['b'] * 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the CPU decode is many small ops, and the
    cores are left to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def metas(hm):
    cif = hm.Cif('cif', 'test', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS,
                 score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
    caf = hm.Caf('caf', 'test', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS,
                 skeleton=constants.COCO_PERSON_SKELETON)
    tcaf = hm.Tcaf('tcaf', 'test',
                   keypoints_single_frame=constants.COCO_KEYPOINTS,
                   sigmas_single_frame=constants.COCO_PERSON_SIGMAS)
    for i, m in enumerate((cif, caf, tcaf)):
        m.base_stride = STRIDE
        m.head_index = i
    return cif, caf, tcaf


def person(name, frame):
    dx, _ = SCHEDULE[name]
    move = 6.0 * frame if name == 'moving' else 0.0
    return synthetic_pose(offset_px=(80.0 + dx + move, 60.0), scale=20.0)


def frame_fields(frame):
    return build_fields([person(n, frame) for n, (_, present)
                         in SCHEDULE.items() if frame in present],
                        h=SIDE, w=SIDE, stride=STRIDE)


def last_seen(name, frame):
    present = [f for f in SCHEDULE[name][1] if f < frame]
    return present[-1] if present else None


def tcaf_field(frame):
    """Every person present in ``frame`` linked from where it was last
    seen (itself in the first frame)."""
    field = np.zeros((17, 9, SIDE, SIDE), np.float32)
    field[:, 0] = -10.0
    for name, (_, present) in SCHEDULE.items():
        if frame not in present:
            continue
        seen = last_seen(name, frame)
        kp1, scales = person(name, frame if seen is None else seen)
        kp2, _ = person(name, frame)
        paint_tcaf(field, kp1, kp2, scales, STRIDE)
    return field


def pair_fields(frame):
    prev_cif, prev_caf = frame_fields(max(0, frame - 1))
    cif, caf = frame_fields(frame)
    return [np.stack([prev_cif, cif]), np.stack([prev_caf, caf]),
            tcaf_field(frame)]


@pytest.fixture(name='decoders')
def fixture_decoders(monkeypatch):
    monkeypatch.setattr(JaxTrackingPose, 'forget_after', FORGET_AFTER)
    monkeypatch.setattr(TrackingPose, 'forget_after', FORGET_AFTER)
    return (JaxTrackingPose(*metas(jax_headmeta)),
            TrackingPose(*metas(headmeta), device='cpu'))


def by_id(anns):
    return {a.id_: a.data for a in anns}


def assert_same_tracks(want, got, label):
    want, got = by_id(want), by_id(got)
    assert sorted(got) == sorted(want), label
    for i, data in want.items():
        np.testing.assert_allclose(got[i], data, rtol=0, atol=TOL,
                                   err_msg=f'{label}, id {i}')


def test_painted_sequence(decoders):
    jax_dec, dec = decoders
    ids = []
    for frame, sequence in enumerate(SEQUENCES):
        fields = pair_fields(frame)
        meta = {'sequence_id': sequence}
        want = jax_dec(fields, meta=dict(meta))
        got = dec([torch.from_numpy(f) for f in fields], meta=dict(meta))
        assert_same_tracks(want, got, f'frame {frame}')
        ids.append({round(float(a.data[0, 0]), 0): a.id_ for a in got})
        assert dec.frame_number == jax_dec.frame_number
        assert dec.next_track_id == jax_dec.next_track_id

    def id_of(name, frame):
        x = round(float(person(name, frame)[0][0, 0]), 0)
        return ids[frame][x]

    # the moving person keeps its id through sequence a, a new one in b
    assert len({id_of('moving', f) for f in range(8)}) == 1
    assert id_of('moving', 8) != id_of('moving', 7)
    # one frame missing (< forget_after): recovered; four (>): a new id
    assert id_of('short_gap', 3) == id_of('short_gap', 1)
    assert id_of('long_gap', 5) != id_of('long_gap', 0)
    assert id_of('new', 3) not in set().union(
        *(ids[f].values() for f in range(3)))


def test_batch_fields_interleaved(decoders):
    """Three pairs in one interleaved batch, as the tracking model gives
    them: (2B, ...) single-frame fields and (B, ...) TCAF."""
    jax_dec, dec = decoders
    pairs = [pair_fields(f) for f in (1, 2, 3)]
    fields = [np.concatenate([p[0] for p in pairs]),
              np.concatenate([p[1] for p in pairs]),
              np.stack([p[2] for p in pairs])]
    metas_ = [{'sequence_id': s} for s in ('x', 'x', 'y')]
    want = jax_dec.batch_fields(fields, metas=[dict(m) for m in metas_])
    got = dec.batch_fields([torch.from_numpy(f) for f in fields],
                           metas=[dict(m) for m in metas_])
    assert len(got) == len(want) == 3
    for i, (w, g) in enumerate(zip(want, got)):
        assert_same_tracks(w, g, f'pair {i}')


def test_eval_reset_signal(decoders):
    jax_dec, dec = decoders
    for d in decoders:
        d([np.asarray(f) for f in pair_fields(1)])
    assert dec.next_track_id > 1 and dec.frame_number == 1
    list(LoaderWithReset([1, 2]))
    assert dec.next_track_id == 1 and dec.frame_number == 0
    JaxSignal.emit('eval_reset')
    assert jax_dec.next_track_id == 1


def test_factory_precedence():
    tracking_metas = list(metas(headmeta))
    assert isinstance(decoder.factory(tracking_metas, device='cpu'),
                      TrackingPose)
    assert isinstance(decoder.factory(tracking_metas[:2], device='cpu'),
                      CifCaf)
    parser = argparse.ArgumentParser()
    decoder.cli(parser)
    try:
        decoder.configure(parser.parse_args(['--decoder', 'cifcaf']))
        assert type(decoder.factory(tracking_metas, device='cpu')) is CifCaf
    finally:
        decoder.configure(parser.parse_args([]))
    assert PoseSimilarity in decoder.DECODERS
    assert not PoseSimilarity.match(tracking_metas)


def test_pose_similarity():
    """The tracker without a TCAF head: the same ids and poses as JAX's
    over frames where one person moves and one, with its legs unseen (so
    that the two scores differ), appears."""
    jax_cif, jax_caf, _ = metas(jax_headmeta)
    cif, caf, _ = metas(headmeta)
    jax_dec = JaxPoseSimilarity(jax_cif, jax_caf)
    dec = PoseSimilarity(cif, caf, device='cpu')
    for frame in range(4):
        people = [person('moving', frame)]
        if frame >= 2:
            kp, scales = person('new', frame)
            kp[11:, 2] = 0.0
            people.append((kp, scales))
        fields = list(build_fields(people, h=SIDE, w=SIDE, stride=STRIDE))
        want = jax_dec(fields)
        got = dec([torch.from_numpy(f) for f in fields])
        assert_same_tracks(want, got, f'frame {frame}')
    assert sorted(a.id_ for a in got) == [1, 2]
