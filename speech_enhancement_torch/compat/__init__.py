"""Weight converters into the port's modules."""

from speech_enhancement_torch.compat.jax_weights import (complex_bn_stacked_state_from_jax,
                                                         complex_conv_state_from_jax,
                                                         complex_dense_state_from_jax,
                                                         conv_tasnet_state_from_jax,
                                                         crn_state_from_jax, dccrn_state_from_jax,
                                                         dcunet_state_from_jax,
                                                         demucs_state_from_jax, dnn_state_from_jax,
                                                         ema_state_from_jax,
                                                         mel_rnn_state_from_jax,
                                                         pcen_state_from_jax,
                                                         rnn_stft_mask_state_from_jax,
                                                         sepformer_state_from_jax,
                                                         tcn_state_from_jax, unet_state_from_jax,
                                                         wav_unet_state_from_jax)

__all__ = ["complex_bn_stacked_state_from_jax", "complex_conv_state_from_jax",
           "complex_dense_state_from_jax", "conv_tasnet_state_from_jax", "crn_state_from_jax",
           "dccrn_state_from_jax", "dcunet_state_from_jax", "demucs_state_from_jax",
           "dnn_state_from_jax", "ema_state_from_jax", "mel_rnn_state_from_jax",
           "pcen_state_from_jax", "rnn_stft_mask_state_from_jax", "sepformer_state_from_jax",
           "tcn_state_from_jax", "unet_state_from_jax", "wav_unet_state_from_jax"]
