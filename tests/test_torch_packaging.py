"""pyproject.toml names every package of the port: a directory of
mimm_tpu_torch/ that holds an ``__init__.py`` and is missing from
``[tool.setuptools] packages`` would be left out of a non-editable
install, whose entry points then fail to import it."""

import os
import tomllib

import pytest

from tests.torch_port_child import REPO


def _port_packages():
    out = []
    for root, dirs, files in os.walk(os.path.join(REPO, "mimm_tpu_torch")):
        dirs[:] = sorted(d for d in dirs if not d.startswith((".", "__")))
        if "__init__.py" in files:
            out.append(os.path.relpath(root, REPO).replace(os.sep, "."))
    return sorted(out)


def _listed():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return set(tomllib.load(f)["tool"]["setuptools"]["packages"])


@pytest.mark.parametrize("package", _port_packages())
def test_port_package_is_listed(package):
    assert package in _listed(), (
        f"{package} has an __init__.py but pyproject.toml's "
        f"[tool.setuptools] packages does not name it")


def test_listed_port_packages_exist():
    stale = sorted(p for p in _listed() if p.startswith("mimm_tpu_torch")
                   and p not in _port_packages())
    assert not stale, f"pyproject.toml names missing packages: {stale}"
