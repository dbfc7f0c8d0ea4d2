# Copied from iemic_tpu/config.py (numpy-only; importing iemic_tpu would import jax).
"""Layered parameter-list configuration system.

Re-implements the contract of the reference's Teuchos::ParameterList use
(reference src/utils/Utils.H:189 ``overwriteParameters``/``obtainParameters``,
src/tests/test_parameterlist.C): every component exposes
``get_default_parameters()``; user input is validated against the defaults
and missing entries are filled in; hierarchically dominant lists (e.g.
CoupledModel, Continuation) overwrite submodel lists at startup.

Parameter *names* are kept identical to the reference XML files
(parameterfiles/*.xml) so that existing experiment configs can be loaded
directly with :func:`read_xml`.
"""

from __future__ import annotations

import copy
import xml.etree.ElementTree as ET
from typing import Any, Iterator


class ParameterList:
    """A nested, ordered dict of parameters and sublists.

    Mirrors the semantics the reference relies on (Teuchos):
      * ``get(name, default)`` returns the value if present, otherwise
        *sets* the default and returns it.
      * ``set(name, value)`` always overwrites.
      * sublists are created on first access via ``sublist(name)``.
      * ``validate_and_set_defaults(defaults)`` errors on parameters not
        present in the defaults list, fills missing ones in.
      * ``update(other)`` recursively overwrites from another list
        (the reference's setParameters / overwriteParameters).
    """

    def __init__(self, name: str = "ANONYMOUS", data: dict | None = None):
        self.name = name
        self._data: dict[str, Any] = {}
        if data:
            for k, v in data.items():
                if isinstance(v, dict):
                    self._data[k] = ParameterList(k, v)
                else:
                    self._data[k] = v

    # -- basic access -------------------------------------------------
    def get(self, name: str, default: Any = None) -> Any:
        if name not in self._data:
            if default is None:
                raise KeyError(
                    f"Parameter '{name}' not found in list '{self.name}' "
                    "and no default given")
            self._data[name] = default
        return self._data[name]

    def set(self, name: str, value: Any) -> None:
        self._data[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._data[name] = value

    def items(self) -> Iterator[tuple[str, Any]]:
        return iter(self._data.items())

    def keys(self):
        return self._data.keys()

    def sublist(self, name: str) -> "ParameterList":
        if name not in self._data:
            self._data[name] = ParameterList(name)
        val = self._data[name]
        if not isinstance(val, ParameterList):
            raise TypeError(f"Parameter '{name}' exists but is not a sublist")
        return val

    def is_sublist(self, name: str) -> bool:
        return isinstance(self._data.get(name), ParameterList)

    # -- layered semantics --------------------------------------------
    def update(self, other: "ParameterList") -> None:
        """Recursively overwrite entries of self with entries of other."""
        for k, v in other.items():
            if isinstance(v, ParameterList):
                self.sublist(k).update(v)
            else:
                self._data[k] = v

    def validate_and_set_defaults(self, defaults: "ParameterList") -> None:
        """Error on unknown parameters, fill in missing defaults.

        Mirrors Teuchos validateParametersAndSetDefaults as used at
        e.g. reference src/continuation/Continuation.H:37.
        """
        for k, v in self._data.items():
            if k not in defaults:
                raise KeyError(
                    f"Unknown parameter '{k}' in list '{self.name}'")
            dv = defaults[k]
            if isinstance(v, ParameterList) != isinstance(dv, ParameterList):
                raise TypeError(f"Parameter '{k}' type mismatch "
                                f"(sublist vs value) in '{self.name}'")
            if isinstance(v, ParameterList):
                v.validate_and_set_defaults(dv)
        for k, dv in defaults.items():
            if k not in self._data:
                self._data[k] = copy.deepcopy(dv)

    def copy(self) -> "ParameterList":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, ParameterList) else v
        return out

    def __repr__(self) -> str:
        return f"ParameterList({self.name!r}, {self.to_dict()!r})"


def _parse_value(type_: str, value: str) -> Any:
    if type_ == "double":
        return float(value)
    if type_ == "int":
        return int(value)
    if type_ == "bool":
        return value.strip().lower() in ("true", "1", "yes")
    if type_ == "char":
        return value.strip()
    if type_ == "string":
        return value
    raise ValueError(f"Unsupported parameter type {type_!r}")


def _from_xml_element(elem: ET.Element) -> ParameterList:
    plist = ParameterList(elem.get("name", "ANONYMOUS"))
    for child in elem:
        if child.tag == "ParameterList":
            plist.set(child.get("name", "ANONYMOUS"), _from_xml_element(child))
        elif child.tag == "Parameter":
            plist.set(child.get("name"),
                      _parse_value(child.get("type"), child.get("value")))
    return plist


def read_xml(path: str) -> ParameterList:
    """Read a Teuchos-style XML parameter file (reference parameterfiles/)."""
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != "ParameterList":
        raise ValueError(f"{path}: root element must be ParameterList")
    return _from_xml_element(root)


def write_xml(plist: ParameterList, path: str) -> None:
    """Write a ParameterList as Teuchos-style XML."""

    def type_of(v: Any) -> str:
        if isinstance(v, bool):
            return "bool"
        if isinstance(v, int):
            return "int"
        if isinstance(v, float):
            return "double"
        return "string"

    def build(plist: ParameterList) -> ET.Element:
        elem = ET.Element("ParameterList", name=plist.name)
        for k, v in plist.items():
            if isinstance(v, ParameterList):
                sub = build(v)
                sub.set("name", k)
                elem.append(sub)
            else:
                ET.SubElement(elem, "Parameter", name=k, type=type_of(v),
                              value=str(v).lower() if isinstance(v, bool)
                              else str(v))
        return elem

    tree = ET.ElementTree(build(plist))
    ET.indent(tree)
    tree.write(path)
