"""Configuration base class.

Port of ``openpifpaf_tpu/configurable.py``.  Reference parity:
``src/openpifpaf/configurable.py:~10``: configuration lives in class
attributes that ``cli()`` / ``configure()`` classmethods set; constructors
also take keyword overrides of those attributes, so that library code can
avoid the shared class state.
"""

from __future__ import annotations


class Configurable:
    """Base for classes configured through class attributes.

    The constructor takes keyword overrides of any declared attribute and
    raises ``ValueError`` on a name the class does not declare (the
    reference's contract).

    Subclasses may also define::

        @classmethod
        def cli(cls, parser):        # add an argparse group
        @classmethod
        def configure(cls, args):    # copy parsed args into class attrs
    """

    def __init__(self, **kwargs):
        for key, value in kwargs.items():
            if not hasattr(self.__class__, key):
                raise ValueError(
                    f'{self.__class__.__name__} has no configuration '
                    f'attribute {key!r}')
            setattr(self, key, value)

    @classmethod
    def cli(cls, parser):
        """Add this class's options to an argparse parser."""

    @classmethod
    def configure(cls, args):
        """Apply parsed argparse values to class attributes."""
