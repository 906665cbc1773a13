"""Mission configs: the YAML groups, their loader and `build_components`."""

from .loader import ConfigNode, build_components, load_config  # noqa: F401
