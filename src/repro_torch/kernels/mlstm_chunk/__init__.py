"""The chunkwise mLSTM kernel (CUDA) and its plain PyTorch versions."""
