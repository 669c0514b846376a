"""The plain reference: GPT-2 and Qwen2 forward and loss (``model.py``) and
three training steps with PowerSGD, error feedback, the DP mean and AdamW
(``train.py``), in float32 with TF32 off. Plain ``torch`` only: it imports
nothing of the port and works out for itself what the port derives from
the seed (the shape groups, the warm-start Q, the EF state)."""
