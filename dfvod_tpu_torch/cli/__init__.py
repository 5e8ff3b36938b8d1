"""Command-line entry points with the reference's flag surface
(``main.py:31-194``, ``main_multi.py:28-177``):

``python -m dfvod_tpu_torch.cli.main``       single-frame training / eval
``python -m dfvod_tpu_torch.cli.main_multi`` TransVOD / TransVOD++
"""
