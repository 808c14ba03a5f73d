"""Forge: the versioned package store (a copy of veles_tpu/forge/store.py).
The deploy control plane reads ``forge://<root>/<name>[@version]`` weight
sources from it; the Forge server and client (ROADMAP.md item 8) are not
ported."""

from .store import ForgeStore, Manifest

__all__ = ["ForgeStore", "Manifest"]
