"""Weight converters into the port's modules."""

from speech_enhancement_torch.compat.jax_weights import (crn_state_from_jax, dccrn_state_from_jax,
                                                         mel_rnn_state_from_jax,
                                                         rnn_stft_mask_state_from_jax,
                                                         sepformer_state_from_jax)

__all__ = ["crn_state_from_jax", "dccrn_state_from_jax", "mel_rnn_state_from_jax",
           "rnn_stft_mask_state_from_jax", "sepformer_state_from_jax"]
