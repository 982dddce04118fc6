"""The PyTorch port stands alone and runs on the card unless told otherwise.

- ``openpifpaf_tpu_torch``, ``chip_smoke.py`` and ``multi_gpu_smoke.py``
  import no ``jax``, ``flax``, ``optax``, ``PIL`` or ``openpifpaf_tpu``
  (the machine with the card has none of them), the training path and
  the COCO-format data
  modules included; no port module reaches PIL through ``importlib``
  either (``image_io`` reads JPEG, BMP and PNG and
  ``transforms.JpegCompression`` round-trips without it);
- importing every module of the port loads no ``matplotlib`` and no
  ``cv2``: the rendering functions of ``show``, ``visualizer`` and
  ``logs`` import matplotlib when they run, ``video.FrameReader`` OpenCV
  when it opens a video file, never at module level (the card's machine
  has neither); the top level imports no torch and has no ``register``;
- entry points (the predict CLI and the detection decoders among them)
  default to ``device='cuda'`` and raise without CUDA instead of falling
  back to the CPU;
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
    files = [os.path.join(REPO, 'chip_smoke.py'),
             os.path.join(REPO, 'multi_gpu_smoke.py')]
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
    assert os.path.join(REPO, 'multi_gpu_smoke.py') in files
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
                 'datasets/loader_with_reset.py', 'predict.py', 'logger.py',
                 'debug_checks.py', 'decoder/cifdet.py', 'decoder/multi.py',
                 'encoder/cifdet.py', 'datasets/multimodule.py',
                 'datasets/image_list.py',
                 'plugins/cifar10/__init__.py',
                 'plugins/cifar10/datamodule.py', 'models/resnet.py',
                 'models/mobilenet.py', 'models/squeezenet.py',
                 'models/effnetv2.py', 'models/swin.py', 'models/xcit.py',
                 'models/botnet.py', 'models/hrformer.py',
                 'transforms/base.py', 'transforms/image.py',
                 'transforms/minsize.py', 'transforms/multi_scale.py',
                 'transforms/random.py', 'transforms/rotate.py',
                 'transforms/toannotations.py', 'transforms/unclipped.py',
                 'transforms/video.py', 'plugins/coco/dataset.py',
                 'plugins/coco/cocokp.py', 'plugins/coco/cocodet.py',
                 'plugins/generic_kp.py', 'plugins/crowdpose/__init__.py',
                 'plugins/crowdpose/constants.py',
                 'plugins/animalpose/__init__.py',
                 'plugins/apollocar3d/__init__.py',
                 'plugins/posetrack/constants.py',
                 'plugins/posetrack/cocokpst.py',
                 'plugins/posetrack/posetrack2018.py',
                 'models/converter.py', 'models/model_migration.py',
                 'migrate.py', 'export_program.py',
                 'export_onnx.py', 'export_coreml.py', 'onnx_native.py',
                 'count_ops.py', 'encoder/native.py', 'profiler.py',
                 'show/__init__.py', 'show/canvas.py', 'show/painters.py',
                 'show/animation_frame.py', 'show/cli.py',
                 'visualizer/__init__.py', 'visualizer/base.py',
                 'visualizer/cif.py', 'visualizer/caf.py',
                 'visualizer/cifhr.py', 'visualizer/seeds.py',
                 'visualizer/occupancy.py', 'visualizer/cifdet.py',
                 'visualizer/tcaf.py', 'logs.py', 'parallel/__init__.py',
                 'parallel/mesh.py', 'parallel/spatial.py',
                 'parallel/scaling.py', 'benchmark_scaling.py',
                 'benchmark.py', 'configurable.py', 'plugin.py',
                 'datasets/torch_dataset.py', 'jpeg.py', 'jpeg_plain.py',
                 'host_library.py'):
        assert os.path.join(REPO, 'openpifpaf_tpu_torch', name) in files
    assert len(files) > 20


@pytest.mark.parametrize('path', port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    bad = [m for m in imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{os.path.relpath(path, REPO)} imports {bad}'


def lazy_pil_imports(path):
    """The ``importlib.import_module('PIL...')`` calls of a source."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return [node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, 'attr', None) == 'import_module'
            and node.args and isinstance(node.args[0], ast.Constant)
            and str(node.args[0].value).startswith('PIL')]


def test_pil_only_where_the_jax_behaviour_needs_it():
    """No port module reaches PIL, not even in a call: JPEG, BMP and PNG
    files and ``JpegCompression`` go through the port's own readers and
    codec (``image_io``, ``jpeg``)."""
    users = {os.path.relpath(p, REPO) for p in port_sources()
             if lazy_pil_imports(p)}
    assert users == set()


def test_import_loads_no_jax_and_builds_nothing():
    """Importing the whole port in a fresh interpreter pulls in none of the
    forbidden modules and starts no kernel build."""
    code = (
        'import subprocess\n'
        'def refuse(*a, **kw): raise AssertionError(f"subprocess at import: {a}")\n'
        'subprocess.run = subprocess.Popen = refuse\n'
        'import sys, openpifpaf_tpu_torch as top\n'
        # the JAX package's plugin discovery imports the port's top level
        'assert not hasattr(top, "register") and "torch" not in sys.modules\n'
        'import openpifpaf_tpu_torch.predictor, openpifpaf_tpu_torch.ops, '
        'openpifpaf_tpu_torch.train, openpifpaf_tpu_torch.eval, '
        'openpifpaf_tpu_torch.metric, openpifpaf_tpu_torch.plugins.toykp, '
        'openpifpaf_tpu_torch.plugins.wholebody.constants, '
        'openpifpaf_tpu_torch.video, openpifpaf_tpu_torch.signal_, '
        'openpifpaf_tpu_torch.image_io, openpifpaf_tpu_torch.ops.tracking, '
        'openpifpaf_tpu_torch.jpeg, openpifpaf_tpu_torch.jpeg_plain, '
        'openpifpaf_tpu_torch.decoder.tracking_pose, '
        'openpifpaf_tpu_torch.models.tracking_base, '
        'openpifpaf_tpu_torch.plugins.posetrack, '
        'openpifpaf_tpu_torch.metric.posetrack, '
        'openpifpaf_tpu_torch.predict, openpifpaf_tpu_torch.logger, '
        'openpifpaf_tpu_torch.debug_checks, '
        'openpifpaf_tpu_torch.decoder.cifdet, '
        'openpifpaf_tpu_torch.decoder.multi, '
        'openpifpaf_tpu_torch.encoder.cifdet, '
        'openpifpaf_tpu_torch.datasets.multimodule, '
        'openpifpaf_tpu_torch.datasets.image_list, '
        'openpifpaf_tpu_torch.plugins.cifar10, '
        'openpifpaf_tpu_torch.models.resnet, '
        'openpifpaf_tpu_torch.models.mobilenet, '
        'openpifpaf_tpu_torch.models.squeezenet, '
        'openpifpaf_tpu_torch.models.effnetv2, '
        'openpifpaf_tpu_torch.models.swin, openpifpaf_tpu_torch.models.xcit, '
        'openpifpaf_tpu_torch.models.botnet, '
        'openpifpaf_tpu_torch.models.hrformer, '
        'openpifpaf_tpu_torch.transforms, '
        'openpifpaf_tpu_torch.plugins.coco, '
        'openpifpaf_tpu_torch.plugins.generic_kp, '
        'openpifpaf_tpu_torch.plugins.crowdpose, '
        'openpifpaf_tpu_torch.plugins.wholebody, '
        'openpifpaf_tpu_torch.plugins.animalpose, '
        'openpifpaf_tpu_torch.plugins.apollocar3d, '
        'openpifpaf_tpu_torch.plugins.posetrack.cocokpst, '
        'openpifpaf_tpu_torch.plugins.posetrack.posetrack2018, '
        'openpifpaf_tpu_torch.models.converter, '
        'openpifpaf_tpu_torch.models.model_migration, '
        'openpifpaf_tpu_torch.migrate, '
        'openpifpaf_tpu_torch.export_program, '
        'openpifpaf_tpu_torch.export_onnx, '
        'openpifpaf_tpu_torch.export_coreml, '
        'openpifpaf_tpu_torch.onnx_native, '
        'openpifpaf_tpu_torch.count_ops, '
        'openpifpaf_tpu_torch.profiler, openpifpaf_tpu_torch.parallel, '
        'openpifpaf_tpu_torch.parallel.scaling, '
        'openpifpaf_tpu_torch.benchmark_scaling, '
        'openpifpaf_tpu_torch.benchmark, openpifpaf_tpu_torch.configurable, '
        'openpifpaf_tpu_torch.plugin, '
        'openpifpaf_tpu_torch.datasets.torch_dataset, '
        'openpifpaf_tpu_torch.encoder.native as native, '
        'openpifpaf_tpu_torch.kernels as k\n'
        'import openpifpaf_tpu_torch.plugin as p; p.register()\n'
        f'bad = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}]\n'
        'assert not bad, bad\n'
        'assert not k._LIBS and native._LIB is None\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, '-c', code], check=True, env=env,
                   cwd=REPO, timeout=120)


def module_level_imports(path):
    """The modules a source imports outside any function."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    nodes = list(tree.body)
    while nodes:
        node = nodes.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        nodes.extend(ast.iter_child_nodes(node))


def test_import_loads_no_matplotlib():
    """matplotlib is imported inside rendering functions only (and OpenCV
    inside ``FrameReader``), and importing every module of the port in a
    fresh interpreter loads none of them."""
    at_import = {os.path.relpath(p, REPO) for p in port_sources()
                 if any(m.split('.')[0] in ('matplotlib', 'cv2')
                        for m in module_level_imports(p))}
    assert not at_import
    code = (
        'import importlib, pkgutil, sys\n'
        'import openpifpaf_tpu_torch as port\n'
        'names = [m.name for m in pkgutil.walk_packages(port.__path__, '
        '"openpifpaf_tpu_torch.")]\n'
        'for name in names:\n'
        '    importlib.import_module(name)\n'
        'assert len(names) > 100, len(names)\n'
        'assert "openpifpaf_tpu_torch.logs" in sys.modules\n'
        'bad = [m for m in sys.modules\n'
        '       if m.split(".")[0] in ("matplotlib", "cv2")]\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, '-c', code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_native_painters_build_at_first_use(tmp_path):
    """Importing the encoders, building them and a data module's training
    chain compiles nothing and loads no library; the first native paint
    builds ``csrc/encoders.cpp`` with ``$CXX`` (here a compiler that
    records its call and fails, in a fresh interpreter)."""
    log = tmp_path / 'cxx.log'
    cxx = tmp_path / 'cxx'
    cxx.write_text(f'#!/bin/sh\necho "$@" >> {log}\nexit 1\n')
    cxx.chmod(0o755)
    code = (
        'import numpy as np, torch\n'
        'from openpifpaf_tpu_torch import encoder\n'
        'from openpifpaf_tpu_torch.encoder import native\n'
        'from openpifpaf_tpu_torch.plugins.toykp import ToyKp, '
        'ToyKpDataset, coco_head_metas\n'
        'metas = coco_head_metas()\n'
        'for m in metas: m.base_stride = 16\n'
        'dm = ToyKp(); dm.head_metas = metas\n'
        'preprocess = dm.preprocess(np.random.default_rng(0))\n'
        'encoders = encoder.factory(metas)\n'
        'assert all(e.use_native for e in encoders)\n'
        'assert native._LIB is None and native.PAINTS == 0\n'
        'import os\n'
        f'assert not os.path.exists({str(log)!r})\n'
        'try:\n'
        '    ToyKpDataset(1, 65, preprocess, seed=0)[0]\n'
        'except RuntimeError as e:\n'
        '    assert "native painters" in str(e), e\n'
        'else:\n'
        '    raise AssertionError("no build at first use")\n'
        f'assert "encoders.cpp" in open({str(log)!r}).read()\n')
    env = dict(os.environ, PYTHONPATH=REPO, CXX=str(cxx))
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
    for name in ('resnet50', 'swin_t'):
        with pytest.raises(RuntimeError, match='CUDA'):
            models.factory(name, coco_metas())
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
    from openpifpaf_tpu_torch.plugins.cifar10 import Cifar10
    cifdet_metas = Cifar10().head_metas
    cifdet_metas[0].base_stride = 16
    with pytest.raises(RuntimeError, match='CUDA'):
        decoder.factory(cifdet_metas)
    with pytest.raises(RuntimeError, match='CUDA'):
        decoder.factory(coco_metas() + cifdet_metas)
    from openpifpaf_tpu_torch import predict
    with pytest.raises(RuntimeError, match='CUDA'):
        predict.main(['x.png', '--checkpoint=missing.npz', '-q'])


def test_transfer_and_head_options_default_to_the_card(tmp_path):
    """A checkpoint grafted onto other heads, and the train CLI that does
    it with the head options, raise without CUDA."""
    no_cuda()
    from openpifpaf_tpu_torch import models, train
    from openpifpaf_tpu_torch.models import checkpoint
    from openpifpaf_tpu_torch.plugins.posetrack import ToyKpSt
    from test_torch_port_models import coco_metas

    model = models.factory('shufflenetv2k16', coco_metas(), device='cpu')
    path = str(tmp_path / 'single.npz')
    checkpoint.save(path, variables=models.to_jax_variables(
        model.module.state_dict()), head_metas=model.head_metas,
        basenet_name='shufflenetv2k16', base_stride=16)
    with pytest.raises(RuntimeError, match='CUDA'):
        models.factory(checkpoint=path, head_metas=ToyKpSt().head_metas,
                       head_dropout=0.1)
    with pytest.raises(RuntimeError, match='CUDA'):
        train.main(['--dataset=toykpst', f'--checkpoint={path}',
                    '--head-dropout=0.1', '--cross-talk=0.2',
                    '--head-upsample-stride=2', '-o',
                    str(tmp_path / 'tracking'), '-q'])
    assert not os.path.exists(str(tmp_path / 'tracking.npz'))


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
    from openpifpaf_tpu_torch.encoder import native
    assert native.SOURCE == kernels.CSRC / 'encoders.cpp'
    assert native.library_path().parent == kernels.BUILD_DIR
