"""The benchmark's plain reference, in PyTorch on the host, in f64.

``frozen/`` is a copy of the port's assembly (``models/ocean`` and the
modules it needs, as of commit 7688fa7), so that a later change to the
program cannot move the yardstick; nothing here imports the program.
"""
