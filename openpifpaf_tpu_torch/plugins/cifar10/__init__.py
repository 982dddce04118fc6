"""CIFAR-10 as a detection data module (one CifDet head, 10 categories)."""

from .datamodule import (CATEGORIES, Cifar10, Cifar10Dataset,
                         load_cifar_batches, synthetic_cifar)

__all__ = ['CATEGORIES', 'Cifar10', 'Cifar10Dataset', 'load_cifar_batches',
           'synthetic_cifar']
