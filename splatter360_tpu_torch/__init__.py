"""PyTorch/CUDA port of splatter360_tpu: feed-forward 360° Gaussian splatting.

Two paths run on an NVIDIA Hopper card: serving (posed ERP panoramas ->
encoder -> Gaussians -> direct-ERP render; entry points in `serve.py`) and
the train step with ERP supervision (`train/state.py`). The tile compositor's
forward and backward are hand-written sm_90a CUDA kernels behind one autograd
function (ops/cuda/composite.py). Layout and names mirror the JAX package so
every module has a counterpart there. Entry points run on the card unless the
caller passes device="cpu".
"""
