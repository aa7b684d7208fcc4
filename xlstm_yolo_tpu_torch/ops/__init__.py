"""mLSTM compute of the PyTorch port: plain versions and the CUDA kernel."""
