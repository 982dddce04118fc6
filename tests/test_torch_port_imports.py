"""The PyTorch port stands alone and runs on the card unless told otherwise.

- ``openpifpaf_tpu_torch`` and ``chip_smoke.py`` import no ``jax``,
  ``flax``, ``optax``, ``PIL`` or ``openpifpaf_tpu`` (the machine with the
  card has none of them), the training path included;
- entry points default to ``device='cuda'`` and raise without CUDA instead
  of falling back to the CPU;
- the CUDA kernels' wrappers take CUDA tensors only: the plain versions are
  chosen (by ``cif_hr.accumulate``, ``pair_chain.apply_chain``) only for
  tensors that lie on the CPU.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'PIL', 'openpifpaf_tpu')


def port_sources():
    root = os.path.join(REPO, 'openpifpaf_tpu_torch')
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names if n.endswith('.py')]
    return sorted(files)


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'id', None) == '__import__'
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_sources_found():
    files = port_sources()
    assert os.path.join(REPO, 'chip_smoke.py') in files
    for name in ('train.py', 'training/trainer.py', 'losses/composite.py',
                 'encoder/cif.py', 'transforms/scale.py',
                 'plugins/toykp/datamodule.py', 'datasets/collate.py',
                 'eval.py', 'metric/__init__.py', 'metric/base.py',
                 'metric/coco.py', 'metric/cocoeval.py',
                 'decoder/pose_similarity.py', 'plugins/toykp/toywb.py',
                 'plugins/toykp/crowd.py', 'plugins/wholebody/__init__.py',
                 'plugins/wholebody/constants.py', 'video.py', 'signal_.py',
                 'image_io.py', 'ops/tracking.py', 'decoder/tracking_pose.py',
                 'models/tracking_base.py', 'plugins/posetrack/__init__.py',
                 'plugins/posetrack/toykpst.py', 'metric/posetrack.py',
                 'encoder/tcaf.py', 'transforms/pair.py',
                 'datasets/loader_with_reset.py'):
        assert os.path.join(REPO, 'openpifpaf_tpu_torch', name) in files
    assert len(files) > 20


@pytest.mark.parametrize('path', port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    bad = [m for m in imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{os.path.relpath(path, REPO)} imports {bad}'


def test_import_loads_no_jax_and_builds_nothing():
    """Importing the whole port in a fresh interpreter pulls in none of the
    forbidden modules and starts no kernel build."""
    code = (
        'import subprocess\n'
        'def refuse(*a, **kw): raise AssertionError(f"subprocess at import: {a}")\n'
        'subprocess.run = subprocess.Popen = refuse\n'
        'import sys, openpifpaf_tpu_torch.predictor, openpifpaf_tpu_torch.ops, '
        'openpifpaf_tpu_torch.train, openpifpaf_tpu_torch.eval, '
        'openpifpaf_tpu_torch.metric, openpifpaf_tpu_torch.plugins.toykp, '
        'openpifpaf_tpu_torch.plugins.wholebody.constants, '
        'openpifpaf_tpu_torch.video, openpifpaf_tpu_torch.signal_, '
        'openpifpaf_tpu_torch.image_io, openpifpaf_tpu_torch.ops.tracking, '
        'openpifpaf_tpu_torch.decoder.tracking_pose, '
        'openpifpaf_tpu_torch.models.tracking_base, '
        'openpifpaf_tpu_torch.plugins.posetrack, '
        'openpifpaf_tpu_torch.metric.posetrack, '
        'openpifpaf_tpu_torch.kernels as k\n'
        f'bad = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}]\n'
        'assert not bad, bad\n'
        'assert not k._LIBS\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, '-c', code], check=True, env=env,
                   cwd=REPO, timeout=120)


def no_cuda():
    if torch.cuda.is_available():
        pytest.skip('checks the behaviour without CUDA')


def test_entry_points_default_to_the_card():
    no_cuda()
    from openpifpaf_tpu_torch import decoder, models, ops
    from openpifpaf_tpu_torch.predictor import Predictor
    from test_torch_port_models import coco_metas

    with pytest.raises(RuntimeError, match='CUDA'):
        Predictor(base_name='shufflenetv2k16', head_metas=coco_metas())
    with pytest.raises(RuntimeError, match='CUDA'):
        models.factory('shufflenetv2k16', coco_metas())
    cif, caf = coco_metas()
    with pytest.raises(RuntimeError, match='CUDA'):
        ops.make_batch_decoder(cif_meta=cif, caf_meta=caf,
                               config=ops.CifCafConfig())
    with pytest.raises(RuntimeError, match='CUDA'):
        decoder.factory([cif, caf])
    from openpifpaf_tpu_torch.plugins.posetrack import ToyKpSt
    tracking_metas = ToyKpSt().head_metas
    with pytest.raises(RuntimeError, match='CUDA'):
        decoder.factory(tracking_metas)
    with pytest.raises(RuntimeError, match='CUDA'):
        models.factory('tshufflenetv2k16', tracking_metas)
    with pytest.raises(RuntimeError, match='CUDA'):
        Predictor(base_name='shufflenetv2k16', head_metas=coco_metas(),
                  device='cuda')


def test_kernel_wrapper_refuses_cpu_tensors():
    from openpifpaf_tpu_torch.ops import cif_hr

    v = torch.zeros(1, 2, 8)
    before = cif_hr.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match='CUDA tensor'):
        cif_hr.cif_hr_accumulate(v, v, v, v, out_hw=(4, 4), spacing=2.0,
                                 truncate=1.0)
    assert cif_hr.KERNEL_LAUNCHES == before


def test_kernel_sources_and_build_dir():
    from openpifpaf_tpu_torch import kernels

    assert {p.stem for p in kernels.CSRC.glob('*.cu')} == \
        {'cif_hr', 'pair_chain'}
    assert 'arch=compute_90a,code=sm_90a' in kernels.NVCC_FLAGS
    for name in ('cif_hr', 'pair_chain'):
        assert kernels.library_path(name).parent == kernels.BUILD_DIR
    assert kernels.BUILD_DIR.relative_to(REPO).as_posix() == \
        'build/openpifpaf_tpu_torch'
