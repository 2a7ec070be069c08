"""UNet denoiser and autoencoder decode."""
