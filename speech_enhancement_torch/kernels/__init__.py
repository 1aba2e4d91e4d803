"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas TPU kernel.

Sources live in ``csrc/``; ``_build`` compiles them with ``nvcc`` at first
use and loads them with ctypes. Each wrapper module keeps the kernel's
plain PyTorch version beside it and a ``launches`` counter on the wrapper.
No module here imports ``triton`` or builds anything at import time.
"""


def counted() -> dict:
    """Kernel name -> its wrapper; ``wrapper.launches`` counts the kernel's
    launches in this process (the plain versions count nothing)."""
    from speech_enhancement_torch.kernels import attention, conv_block, lstm, masking, stft

    return {"stft": stft.stft_kernel, "mask_e": masking.mask_e_kernel,
            "conv_block": conv_block.fused_conv_block,
            "deconv_block": conv_block.fused_deconv_block, "enc_bwd_gz": conv_block.enc_bwd_gz,
            "enc_bwd_dw": conv_block.enc_bwd_dw, "dec_bwd_gz": conv_block.dec_bwd_gz,
            "dec_bwd_dw": conv_block.dec_bwd_dw, "lstm_fwd": lstm.lstm_fwd,
            "lstm_bwd": lstm.lstm_bwd, "mha_fwd": attention.mha_fwd,
            "mha_bwd": attention.mha_bwd}
