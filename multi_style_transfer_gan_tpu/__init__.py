"""The package's former name, kept so that existing imports and
``python -m <former name>.cli.<tool>`` commands keep working.

Every submodule resolves from ``multi_style_transfer_gan``'s directory.
Import ``multi_style_transfer_gan`` instead; this alias warns once.
"""

import warnings

import multi_style_transfer_gan as _pkg

warnings.warn(f"{__name__} was renamed to multi_style_transfer_gan; "
              "import that instead", FutureWarning, stacklevel=2)

__path__ = _pkg.__path__
__version__ = _pkg.__version__
