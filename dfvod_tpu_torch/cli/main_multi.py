"""Training CLI, TransVOD / TransVOD++ (counterpart of
``dfvod_tpu/cli/main_multi.py``).

    python -m dfvod_tpu_torch.cli.main_multi <a recipe's arguments>

Parity target: ``main_multi.py:179-484`` of the reference. What differs
from the single-frame CLI is handled inside ``cli/main.py::train_loop``:
the clip dataset and frame rows, the key frames' targets, the
temporal / spatial checkpoint merge (``--transvod_temporal_weights`` /
``--spatial_weights``) and ``--fixed_pretrained_model``, which trains the
temporal parameters only through the optimizer's labels
(``train/optim.py``). ``--dataset_file vid_multi`` selects TransVOD,
``vid_multi_plusplus`` TransVOD++.
"""
from dfvod_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(video=True)
