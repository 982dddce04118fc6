"""The port's ``profiler.py`` on the CPU.

- ``Profiler`` writes cProfile's stats to ``out_name`` (readable by
  ``pstats``) and, with a trace directory, a ``torch.profiler`` Chrome
  trace there, whose events hold the regions named by ``TraceAnnotation``;
  ``cli``/``configure`` take JAX's ``--profile`` flag shape.
- ``--profile-decoder`` (``Decoder.profile``) through the port's
  ``Predictor.batch`` (the predict CLI's path; its eval path,
  ``dataset_loader``, decodes through the same ``Predictor.decode``)
  writes the decode's cProfile stats to that file, as the JAX
  ``Predictor`` does (``predictor.py:219-224``), and the image files'
  path through ``dataset_loader`` alike.
"""

import argparse
import json
import os
import pstats

import numpy as np
import pytest
import torch

from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import decoder as decoder_mod, image_io
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.profiler import Profiler, TraceAnnotation

from test_torch_port_decode import one_torch_thread  # noqa: F401  (fixture)
from test_torch_port_models import flax_narrow, port_narrow


def test_profiler_writes_host_stats_and_a_trace(tmp_path):
    out = str(tmp_path / 'host.prof')
    trace_dir = str(tmp_path / 'trace')
    profiler = Profiler(out_name=out, trace_dir=trace_dir)
    with profiler():
        with TraceAnnotation('named region'):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert pstats.Stats(out).total_calls > 0
    assert [os.path.basename(profiler.trace_file)] == os.listdir(trace_dir)
    with open(profiler.trace_file) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'named region' for e in events)
    assert any('mm' in e.get('name', '') for e in events)
    assert 'named region' in {e.key for e in profiler.trace.key_averages()}


def test_profiler_without_a_trace_dir(tmp_path):
    out = str(tmp_path / 'host.prof')
    profiler = Profiler(out_name=out)
    with profiler():
        sum(range(1000))
    assert pstats.Stats(out).total_calls > 0
    assert profiler.trace is None and profiler.trace_file is None


def test_profile_flag(monkeypatch):
    parser = argparse.ArgumentParser()
    Profiler.cli(parser)
    monkeypatch.setattr(Profiler, 'trace_dir', None)
    monkeypatch.setattr(Profiler, 'enabled', False)
    Profiler.configure(parser.parse_args(['--profile']))
    assert Profiler.enabled and Profiler.trace_dir == 'profile_trace'
    assert Profiler(out_name='x').trace_dir == 'profile_trace'
    Profiler.configure(parser.parse_args([]))
    assert not Profiler.enabled and Profiler.trace_dir is None


@pytest.fixture(name='predictor')
def narrow_predictor():
    _, variables, _ = flax_narrow()
    predictor = Predictor(
        model=port_narrow(jax_checkpoint.flatten_tree(variables)),
        device='cpu')
    predictor.long_edge = 65
    return predictor


def test_profile_decoder_through_the_predictor(predictor, tmp_path,
                                               monkeypatch):
    out = str(tmp_path / 'decoder.prof')
    monkeypatch.setattr(decoder_mod.Decoder, 'profile', out)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (65, 49, 3), dtype=np.uint8)
              for _ in range(2)]
    results = predictor.batch(images)
    assert len(results) == 2
    stats = pstats.Stats(out)
    assert any(func[2] == 'batch_fields' for func in stats.stats)


def test_profile_decoder_through_the_loader(predictor, tmp_path,
                                           monkeypatch):
    """The image files' path (``Predictor.images``, then
    ``dataset_loader``) profiles each batch's decode alike."""
    out = str(tmp_path / 'decoder.prof')
    monkeypatch.setattr(decoder_mod.Decoder, 'profile', out)
    rng = np.random.default_rng(1)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f'{i}.png'))
        image_io.write_png(paths[-1], rng.integers(0, 256, (49, 65, 3),
                                                   dtype=np.uint8))
    assert len(list(predictor.images(paths))) == 2
    assert predictor.total_images == 2
    assert any(func[2] == 'batch_fields' for func in pstats.Stats(out).stats)
