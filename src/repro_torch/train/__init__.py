# Training: AdamW / SGD written out (not torch.optim) and the train step
# with microbatch accumulation that QAT runs.
