"""COCO WholeBody plugin: the 133-keypoint constants only.

The JAX package's ``WholeBody`` data module reads COCO-WholeBody json
files, which the repository does not hold; the port has the constants,
which the ``toywb`` data module renders.
"""
