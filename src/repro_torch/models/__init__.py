"""Models of the port (counterpart of ``repro.models``): the §VI-A CNN."""
from . import cnn  # noqa: F401
