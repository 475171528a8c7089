"""Single-token GQA decode attention: plain versions, CUDA kernel, wrapper."""
