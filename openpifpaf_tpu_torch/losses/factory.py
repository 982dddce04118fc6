"""Loss factory and CLI: port of ``openpifpaf_tpu/losses/factory.py`` with
the same flags."""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from . import components
from .composite import CompositeLoss, CompositeLossConfig
from .multi_head import MultiHeadLoss


class Factory:
    lambdas: Optional[Sequence[float]] = None
    focal_gamma: float = 1.0
    background_weight: float = 1.0
    b_min: float = 0.1
    auto_tune_mtl: bool = False
    regression_loss: str = 'laplace'
    r_smooth: float = 0.0

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('losses')
        group.add_argument('--lambdas', default=cls.lambdas, type=float,
                           nargs='+', help='prefactors for all loss components')
        group.add_argument('--focal-gamma', default=cls.focal_gamma,
                           type=float, help='focal loss gamma')
        group.add_argument('--background-weight', default=cls.background_weight,
                           type=float, help='BCE weight of background cells')
        group.add_argument('--b-min', default=cls.b_min, type=float,
                           help='minimum Laplace spread b (cell units)')
        group.add_argument('--auto-tune-mtl', default=cls.auto_tune_mtl,
                           action='store_true',
                           help='learn task-uncertainty weights (Kendall MTL)')
        group.add_argument('--regression-loss', default=cls.regression_loss,
                           choices=('laplace', 'smoothl1'),
                           help='offset regression loss')
        group.add_argument('--r-smooth', default=cls.r_smooth, type=float,
                           help='smoothl1: quadratic-to-linear radius (cells)')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.lambdas = args.lambdas
        cls.focal_gamma = args.focal_gamma
        cls.background_weight = args.background_weight
        cls.b_min = args.b_min
        cls.auto_tune_mtl = args.auto_tune_mtl
        cls.regression_loss = args.regression_loss
        cls.r_smooth = args.r_smooth

    def factory(self, head_metas) -> MultiHeadLoss:
        config = CompositeLossConfig(
            bce=components.BceConfig(
                focal_gamma=self.focal_gamma,
                background_weight=self.background_weight),
            laplace=components.LaplaceConfig(b_min=self.b_min),
            smooth_l1=components.SmoothL1Config(r_smooth=self.r_smooth),
            scale=components.ScaleConfig(),
            regression_loss=self.regression_loss,
        )
        losses = [CompositeLoss(meta, config) for meta in head_metas]
        return MultiHeadLoss(losses, self.lambdas)
