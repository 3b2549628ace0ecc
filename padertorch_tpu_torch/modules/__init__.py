from padertorch_tpu_torch.modules.recurrent import LSTM, GRU
from padertorch_tpu_torch.modules.dual_path_rnn import DPRNN
