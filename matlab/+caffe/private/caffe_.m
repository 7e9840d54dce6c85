function varargout = caffe_(cmd, varargin)
% caffe_  RPC twin of the reference's MEX entry point.
%
% The reference binds MATLAB via a compiled MEX plugin
% (matlab/+caffe/private/caffe_.cpp).  This rebuild runs on
% accelerator hosts, where the runtime is JAX, not MATLAB — so the same
% command surface is served by a bridge daemon instead:
%
%   (GPU host)  python -m mms_answer_selection_tpu.cli matbridge --port 8491
%   (MATLAB)    caffe_('connect', 'gpu-host', 8491);
%               net = caffe.Net('deploy.prototxt', 'test');
%
% Protocol: one JSON object per line over TCP.  Request
% {"cmd": ..., "args": [...]}, response {"ok": true, "out": ...} or
% {"ok": false, "error": msg}.  Numeric arrays travel as
% {"mat": 1, "shape": [...], "data": <base64 of little-endian float32,
% column-major>} — column-major is MATLAB's native order, so encoding
% is typecast(single(x(:)), 'uint8') with no permutation.

persistent conn
if strcmp(cmd, 'connect')
  host = '127.0.0.1'; port = 8491;
  if numel(varargin) >= 1, host = varargin{1}; end
  if numel(varargin) >= 2, port = varargin{2}; end
  conn = tcpclient(host, port);
  configureTerminator(conn, 'LF');
  return
end
if isempty(conn)
  error('caffe_:notconnected', ...
        'not connected: call caffe_(''connect'', host, port) first');
end

req = struct('cmd', cmd, 'args', {cellfun(@encode_arg, varargin, ...
                                          'UniformOutput', false)});
writeline(conn, jsonencode(req));
resp = jsondecode(readline(conn));
if ~resp.ok
  error('caffe_:remote', '%s', resp.error);
end
if isfield(resp, 'out')
  varargout{1} = decode_out(resp.out);
end
end

function v = encode_arg(a)
if ischar(a) || isstring(a)
  v = char(a);
elseif isstruct(a)  % handle structs pass through as JSON objects
  v = a;
elseif isnumeric(a) && isscalar(a)
  v = double(a);
elseif isnumeric(a)
  m = containers.Map({'mat', 'shape', 'data'}, ...
    {1, size(a), matlab.net.base64encode(typecast(single(a(:)), 'uint8'))});
  v = m;
else
  error('caffe_:badarg', 'unsupported argument type %s', class(a));
end
end

function v = decode_out(o)
if isstruct(o) && ~isscalar(o)
  v = arrayfun(@decode_out, o);  % e.g. handle vectors (hBlob_blobs)
elseif isstruct(o) && isfield(o, 'mat')
  raw = matlab.net.base64decode(o.data);
  v = reshape(typecast(uint8(raw), 'single'), reshape(o.shape, 1, []));
elseif isstruct(o)
  v = o;
  f = fieldnames(o);
  for i = 1:numel(f)
    v.(f{i}) = decode_out(o.(f{i}));
  end
elseif iscell(o)
  v = cellfun(@decode_out, o, 'UniformOutput', false);
else
  v = o;
end
end
