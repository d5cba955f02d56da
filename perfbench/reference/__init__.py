"""The benchmark's plain reference: the CSPN-UNet of Cheng et al. (ECCV 2018,
arXiv:1808.00150; XinJCheng/CSPN `cspn_pytorch/models/torch_resnet_cspn_nyu.py`)
in plain PyTorch, float32, in the published form: the zero-insert unpool
and k x k convolutions of the decoder, the padded-canvas affinity
normalization and the 24-step propagation of `cspn_pytorch/models/cspn.py`,
masked L1 and SGD with Nesterov momentum.

It imports nothing of the program under test and nothing of JAX.  It runs
on any device; every function takes its weights as a dict keyed as the
published model's state dict.
"""
