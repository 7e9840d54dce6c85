function solver = get_solver(solver_file)
% solver = caffe.get_solver(solver_file)
% Build a bridge-side solver from a solver prototxt (the file path is
% resolved on the DAEMON's host, next to the accelerator).  The prototxt's
% `type:` field selects the algorithm; all six reference solver types
% run through the same GraphSolver loop.
if ~(ischar(solver_file) || isstring(solver_file))
  error('caffe:get_solver', 'solver_file must be a string');
end
solver = caffe.Solver(caffe_('get_solver', char(solver_file)));
end
