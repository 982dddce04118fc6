"""Readings of ``test_torch_port_train_bf16.py``'s gaps at several torch
CPU thread counts: the port's bf16 and f32 steps, through the canonical
graph and the plan, against JAX's bf16 steps.

Usage (from the repository root): ``JAX_PLATFORMS=cpu python
tests/torch_port_bf16_threads.py 8 6 4 2 1``
"""

import os
import sys

os.environ.setdefault('XLA_FLAGS', '--xla_force_host_platform_device_count=8')
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_port_train_bf16 as bf16  # noqa: E402
import test_torch_port_train_default as default  # noqa: E402
from test_torch_port_losses import toykp_batch  # noqa: E402


def main(counts) -> None:
    batch = toykp_batch(65)
    runs = {}

    def jax_steps(fused_train):
        if fused_train not in runs:
            runs[fused_train] = default.jax_default_steps(
                jnp.bfloat16, *batch, fused_train=fused_train)
        return runs[fused_train]

    for threads in counts:
        torch.set_num_threads(threads)
        for fused_train in (False, True):
            for port_bf16 in (True, False):
                gaps = bf16.bf16_gaps(batch, jax_steps, fused_train,
                                      port_bf16=port_bf16)
                print(f'threads {threads}: {gaps}', flush=True)


if __name__ == '__main__':
    main([int(a) for a in sys.argv[1:]] or [torch.get_num_threads()])
