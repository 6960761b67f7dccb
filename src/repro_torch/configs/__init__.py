"""One module per ported architecture (copies of ``repro.configs``).

Each module exposes ``CONFIG`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family config for CPU smoke tests).
"""
