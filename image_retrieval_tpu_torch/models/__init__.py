"""CLIP towers, encoder facade, tokenizer, preprocessing and weight mapping."""
