"""The 2D -> 3D dataset-synthesis pipeline on the port's models: the
framework-free stages copied from ``spatialrgpt_tpu/synth`` (``geometry``,
``prompts``, ``pipeline``, ``rephrase``, ``visualize``), the CameraNet
calibration model (``calibration``) and the stage models that fill the
pipeline's slots on the card (``models``)."""
