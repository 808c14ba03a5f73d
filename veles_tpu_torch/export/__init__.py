"""Export: native-serving packages (``package.py``, the JAX package's
format) and sealed compiled artifacts (``compiled.py``, ``torch.export``
programs that ``runtime/artifact.py`` serves); the counterpart of
veles_tpu/export.  Nothing is imported here: the artifact runner reads
``compiled.py``'s constants without loading the package writer."""
