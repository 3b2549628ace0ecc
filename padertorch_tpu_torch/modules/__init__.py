from padertorch_tpu_torch.modules.recurrent import LSTM
