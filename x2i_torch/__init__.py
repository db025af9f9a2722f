"""x2i in PyTorch and CUDA for NVIDIA Hopper: the port of x2i_tpu (see
README.md, "PyTorch/CUDA port")."""


def __getattr__(name):
    # lazy, as x2i_tpu's: ``import x2i_torch`` builds no model module
    if name == "TTSPipeline":
        from x2i_torch.streaming import TTSPipeline
        return TTSPipeline
    raise AttributeError(name)
