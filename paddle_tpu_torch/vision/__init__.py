"""Vision models of the port."""

from . import models

__all__ = ["models"]
