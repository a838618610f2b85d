"""Operations and bytes of the measured work, and the card's published
peaks: the arithmetic every roofline share and MFU reads."""
