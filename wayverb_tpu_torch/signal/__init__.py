"""Signal processing: IIR design, multiband FFT filters, resampling."""
