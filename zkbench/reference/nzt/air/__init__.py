"""AIR constraint framework: Felt algebra, components, LogUp lookups."""

from .expr import Felt, NP
from .lookups import LookupElements
from .component import (
    Component, ComponentInfo, component_info, PointEvalContext,
)
