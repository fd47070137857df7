# Synthetic token task for pretraining and QAT.
