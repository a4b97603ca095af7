"""The benchmark's plain PyTorch references: the VAuLT classifier's forward
(:mod:`.vault_ref`) and its first training steps (:mod:`.train_ref`).
Nothing here imports the program under test."""
