"""A configuration's parameter files, written where the program reads
them.

A configuration file (``configs/<name>.json``) holds, under ``files``,
each parameter file of the bundle as ``{"name": <list name>, "params":
{...}}``, nested lists as nested objects, with JSON's types standing for
the XML types (true/false bool, 1 int, 1.0 double, "x" string); and under
``data`` the files of ``configs/`` that the bundle reads, by the path
they take in the work directory.
"""

from __future__ import annotations

import os
import shutil

from reference.frozen.config import ParameterList, write_xml

from .registry import BENCH


def write(config: dict, workdir: str, bench: str = BENCH) -> str:
    """Write the configuration's parameter files and data into workdir
    (made if need be); returns workdir."""
    os.makedirs(workdir, exist_ok=True)
    for fname, body in config["files"].items():
        write_xml(ParameterList(body["name"], body["params"]),
                  os.path.join(workdir, fname))
    for dest, src in config.get("data", {}).items():
        path = os.path.join(workdir, dest)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        shutil.copyfile(os.path.join(bench, src), path)
    return workdir
