"""Profiling helpers.

Port of ``openpifpaf_tpu/profiler.py``.  Reference parity:
``src/openpifpaf/profiler.py:~10`` and ``--profile-decoder``
(``decoder/decoder.py:~60``): the reference wraps the decode in torch's
autograd profiler and cProfile and dumps a table.  Here ``Profiler`` runs
cProfile over a region and, given a trace directory, ``torch.profiler``
beside it (the host's ops, and the card's kernels when CUDA is available),
with the same flag shapes as the JAX package: ``cli``/``configure`` for
``--profile``, which no CLI registers, as in JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import logging
import os
import pstats
import time

import torch

LOG = logging.getLogger(__name__)


class Profiler:
    """cProfile of a region, written to ``out_name`` (its table also
    printed), and with ``trace_dir`` a ``torch.profiler`` trace of it (the
    card's kernels too where CUDA is available) exported there as a
    Chrome trace (``trace_file``; open it with Perfetto or
    ``chrome://tracing``).  ``trace`` keeps the finished
    ``torch.profiler.profile`` for ``key_averages()``."""

    trace_dir = None
    enabled = False

    def __init__(self, out_name: str = 'decoder.prof', trace_dir: str = None):
        self.out_name = out_name
        self.trace_dir = trace_dir if trace_dir is not None \
            else type(self).trace_dir
        self.trace = None
        self.trace_file = None

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('profiler')
        group.add_argument('--profile', default=None, nargs='?',
                           const='profile_trace',
                           help='collect a torch.profiler trace into this '
                                'directory')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.trace_dir = args.profile
        cls.enabled = args.profile is not None

    @contextlib.contextmanager
    def __call__(self):
        host = cProfile.Profile()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        trace = (torch.profiler.profile(activities=activities)
                 if self.trace_dir else contextlib.nullcontext())
        try:
            with trace:
                host.enable()
                try:
                    yield self
                finally:
                    host.disable()
        finally:
            host.dump_stats(self.out_name)
            LOG.info('host profile written to %s (top entries follow)',
                     self.out_name)
            pstats.Stats(host).sort_stats('cumulative').print_stats(10)
            if self.trace_dir:
                os.makedirs(self.trace_dir, exist_ok=True)
                self.trace = trace
                self.trace_file = os.path.join(
                    self.trace_dir,
                    f'trace-{os.getpid()}-{time.time_ns()}.json')
                trace.export_chrome_trace(self.trace_file)
                LOG.info('torch.profiler trace -> %s', self.trace_file)


class TraceAnnotation(torch.profiler.record_function):
    """A named region in the trace (JAX's ``TraceAnnotation``)."""
