"""Programs of ``export_program --include-decoder`` for
``test_torch_port_export_decoder.py``, one case per process, so that the
test traces its cases side by side (tracing the decode's nested loops
takes seconds each).  Torch and the port only: a process starts without
JAX.

    python tests/torch_port_export_cases.py CASE WEIGHTS.npz OUT_DIR

builds ``narrow_model`` from the flat JAX variables in ``WEIGHTS.npz`` and,
for each (export batch, run batches) of ``CASES[CASE]``, exports it with
the decode under ``decode_options(CASE)`` (export batch ``None``:
``--dynamic-batch``), saves the program to ``OUT_DIR/CASE_BATCH.pt2``,
loads it back and runs it on ``images(b)`` for each run batch b.  It
writes the outputs, and the program's calls of the port's operators, to
``OUT_DIR/CASE_BATCH.npz`` and prints each trace's seconds; the test holds
them to the eager decode.
"""

import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from openpifpaf_tpu_torch import export_program, headmeta, models
from openpifpaf_tpu_torch.decoder.cifcaf import CifCaf
from openpifpaf_tpu_torch.ops import pipeline
from openpifpaf_tpu_torch.plugins.coco import constants

NARROW = ((1, 2, 1), (8, 16, 32, 64, 64))
HW = (65, 65)
# per case, (export batch, run batches): None is the symbolic batch
CASES = {
    'static': ((1, (1,)), (2, (2,))),
    'dynamic': ((None, (1, 2, 3)),),
    'force_complete': ((2, (2,)),),
    'placements': ((2, (2,)),),
}
OPERATORS = ('openpifpaf_tpu_torch.cif_hr_accumulate',
             'openpifpaf_tpu_torch.pair_chain')


def images(batch: int) -> np.ndarray:
    """(batch, 3, 65, 65) float32 standard normal images, seeded by the
    batch size."""
    return np.random.default_rng(batch).normal(
        size=(batch, 3, *HW)).astype(np.float32)


def operator_calls(program) -> dict:
    """Calls of the port's operators in the program's top-level graph."""
    calls = [str(node.target).rsplit('.', 1)[0] for node in
             program.graph.nodes if str(node.target).startswith(OPERATORS)]
    return {name: calls.count(name) for name in OPERATORS}


def coco_metas():
    """cocokp's CIF and CAF metas at stride 16 (``test_torch_port_models``'
    ``coco_metas``)."""
    common = dict(keypoints=constants.COCO_KEYPOINTS,
                  sigmas=constants.COCO_PERSON_SIGMAS,
                  pose=constants.COCO_UPRIGHT_POSE)
    cif = headmeta.Cif('cif', 'port',
                       draw_skeleton=constants.COCO_PERSON_SKELETON,
                       score_weights=constants.COCO_PERSON_SCORE_WEIGHTS,
                       **common)
    caf = headmeta.Caf('caf', 'port', skeleton=constants.COCO_PERSON_SKELETON,
                       **common)
    for m in (cif, caf):
        m.base_stride = 16
    return [cif, caf]


def narrow_model(flat):
    """``test_torch_port_models.port_narrow``: the narrow ShuffleNetV2K
    with CIF and CAF heads, f32, on the CPU, from flat JAX variables."""
    metas = coco_metas()
    shell = models.Shell(models.ShuffleNetV2K(*NARROW),
                         [models.CompositeField4(m, 64) for m in metas])
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    return models.Model(shell, metas, base_stride=16,
                        device=torch.device('cpu'), bf16=False)


@contextlib.contextmanager
def decode_options(case: str):
    """The decoder's options of ``case``, set on ``CifCaf`` and restored:
    ``force_complete`` turns on ``--force-complete-pose``, ``placements``
    places 2 joints per pose and round (``placements_per_round``, which
    has no flag: ``config_for`` is wrapped, as ``chip_smoke.py``'s
    ``with_placements`` does)."""
    saved = CifCaf.force_complete, CifCaf.config_for
    try:
        if case == 'force_complete':
            CifCaf.force_complete = True
        elif case == 'placements':
            def config_for(self, image_hw):
                config = saved[1](self, image_hw)
                return dataclasses.replace(config, growth=dataclasses.replace(
                    config.growth, placements_per_round=2))
            CifCaf.config_for = config_for
        yield
    finally:
        CifCaf.force_complete, CifCaf.config_for = saved


def main(case: str, weights: str, out: str) -> None:
    torch.set_num_threads(1)
    model = narrow_model(dict(np.load(weights)))
    for batch, runs in CASES[case]:
        start = time.perf_counter()
        with decode_options(case):
            program = export_program.export_forward(
                model, HW, batch_size=batch or 1, include_decoder=True,
                dynamic_batch=batch is None)
        seconds = time.perf_counter() - start
        path = os.path.join(out, f'{case}_{batch}')
        torch.export.save(program, f'{path}.pt2')
        program = export_program.load_exported(f'{path}.pt2')
        results = {f'calls {name}': n
                   for name, n in operator_calls(program).items()}
        for run in runs:
            with torch.no_grad():
                got = program.module()(torch.from_numpy(images(run)))
            results.update({f'{field} {run}': t.numpy() for field, t in
                            zip(pipeline.DecodedPoses._fields, got)})
        np.savez(f'{path}.npz', **results)
        print(f'{case} batch {batch}: traced in {seconds:.1f} s', flush=True)


if __name__ == '__main__':
    main(*sys.argv[1:])
